"""Carry state between the JAX package and the port.

The JAX package's dataclasses become numpy trees on its side
(`jax.tree_util.tree_map(np.asarray, x)`); the functions here build the
port's dataclasses from such trees, field by field, so both packages can
start a step from identical state. Nothing here imports JAX: the input
only needs the reference's attribute names.

uint32 incidence words (`obs_bits`) are reinterpreted as int32 bit
patterns, the port's storage for them (see worldmap.stores).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pli_slam_tpu_torch.frontend.frame import FrameData
from pli_slam_tpu_torch.ops.camera import Camera
from pli_slam_tpu_torch.ops.lines import LineFeatures
from pli_slam_tpu_torch.ops.orb import Features
from pli_slam_tpu_torch.utils.config import SlamConfig
from pli_slam_tpu_torch.worldmap.stores import KeyFrameStore, LineStore, PointStore
from pli_slam_tpu_torch.worldmap.vocab import BowDatabase, Vocabulary


def _dataclass_from_dict(cls, d: dict, where: str):
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown, missing = sorted(set(d) - set(fields)), sorted(set(fields) - set(d))
    if unknown or missing:
        raise ValueError(f"{where}: unknown fields {unknown}, missing fields {missing}")
    kw = {}
    for name, f in fields.items():
        sub = type(f.default)  # every nested config is a dataclass-typed default
        kw[name] = _dataclass_from_dict(sub, d[name], f"{where}.{name}") if dataclasses.is_dataclass(sub) else d[name]
    return cls(**kw)


def config_from_reference(d: dict) -> SlamConfig:
    """The port's SlamConfig from `dataclasses.asdict` of the JAX package's:
    a plain dict goes in, so no object of that package comes across. Every
    field must be there and none besides: a field that one package has and
    the other lacks raises."""
    return _dataclass_from_dict(SlamConfig, d, "SlamConfig")


def tensor(x, device=None) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _tensors(cls, obj, device, nested=None):
    nested = nested or {}
    kw = {}
    for f in dataclasses.fields(cls):
        v = getattr(obj, f.name)
        kw[f.name] = nested[f.name](v, device) if f.name in nested else tensor(v, device)
    return cls(**kw)


def camera(c) -> Camera:
    return Camera(fx=float(np.asarray(c.fx)), fy=float(np.asarray(c.fy)), cx=float(np.asarray(c.cx)),
                  cy=float(np.asarray(c.cy)), k=tuple(float(v) for v in np.asarray(c.k)),
                  bf=float(np.asarray(c.bf)), width=int(c.width), height=int(c.height), model=int(c.model))


def features(x, device=None) -> Features:
    return _tensors(Features, x, device)


def line_features(x, device=None) -> LineFeatures:
    return _tensors(LineFeatures, x, device)


def frame_data(x, device=None) -> FrameData:
    return _tensors(FrameData, x, device, {"feats": features, "lines": line_features})


def point_store(x, device=None) -> PointStore:
    return _tensors(PointStore, x, device)


def line_store(x, device=None) -> LineStore:
    return _tensors(LineStore, x, device)


def keyframe_store(x, device=None) -> KeyFrameStore:
    return _tensors(KeyFrameStore, x, device)


def bow_database(x, device=None) -> BowDatabase:
    return _tensors(BowDatabase, x, device)


def vocabulary(v) -> Vocabulary:
    """The LSH vocabulary is defined by (n_bits, seed); its planes are drawn
    from the same numpy generator in both packages."""
    return Vocabulary(n_bits=int(v.n_bits), seed=int(v.seed))


def to_numpy(obj, prefix: str = "") -> dict[str, np.ndarray]:
    """Flatten a (nested) dataclass of tensors or arrays into {dotted name: numpy}.
    int32 `obs_bits` words are shown as uint32, the reference's dtype."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        name = prefix + f.name
        if dataclasses.is_dataclass(v):
            out.update(to_numpy(v, name + "."))
        else:
            a = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            out[name] = a.view(np.uint32) if f.name == "obs_bits" and a.dtype == np.int32 else a
    return out
