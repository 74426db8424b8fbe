"""Struct-of-arrays map stores (port of pli_slam_tpu.worldmap.stores).

Same fields, slot layouts and dtypes as the reference, with one
exception: the keyframe-incidence bitsets `obs_bits` are int32 tensors
holding the bit patterns of the reference's uint32 words, because torch
implements few operators for uint32. Every bit operation the port
applies (shift, and, or, select) gives the same bits in int32;
`utils.convert` reinterprets the words when state crosses packages.

Mutation functions are pure: they return new stores.
"""

from __future__ import annotations

import dataclasses

import torch

DESC_BANK = 4


def _z(shape, dtype=torch.float32, device=None):
    return torch.zeros(shape, dtype=dtype, device=device)


@dataclasses.dataclass(frozen=True)
class PointStore:
    x: torch.Tensor  # [P,3]
    desc: torch.Tensor  # [P,256] int8
    valid: torch.Tensor  # [P] bool
    n_obs: torch.Tensor  # [P] int32
    visible: torch.Tensor  # [P] int32
    found: torch.Tensor  # [P] int32
    first_kf: torch.Tensor  # [P] int32
    last_kf: torch.Tensor  # [P] int32
    obs_bits: torch.Tensor  # [P, ceil(K/32)] int32 (uint32 bit patterns)
    desc_bank: torch.Tensor  # [P, DESC_BANK, 256] int8

    @staticmethod
    def empty(capacity: int, kf_capacity: int = 512, device=None) -> "PointStore":
        i32 = torch.int32
        return PointStore(
            x=_z((capacity, 3), device=device),
            desc=_z((capacity, 256), torch.int8, device),
            valid=_z(capacity, torch.bool, device),
            n_obs=_z(capacity, i32, device),
            visible=torch.ones(capacity, dtype=i32, device=device),
            found=torch.ones(capacity, dtype=i32, device=device),
            first_kf=_z(capacity, i32, device),
            last_kf=_z(capacity, i32, device),
            obs_bits=_z((capacity, (kf_capacity + 31) // 32), i32, device),
            desc_bank=_z((capacity, DESC_BANK, 256), torch.int8, device),
        )


@dataclasses.dataclass(frozen=True)
class LineStore:
    seg: torch.Tensor  # [L,6]
    desc: torch.Tensor  # [L,256] int8
    valid: torch.Tensor  # [L] bool
    n_obs: torch.Tensor  # [L] int32
    visible: torch.Tensor  # [L] int32
    found: torch.Tensor  # [L] int32
    first_kf: torch.Tensor  # [L] int32
    last_kf: torch.Tensor  # [L] int32
    obs_bits: torch.Tensor  # [L, ceil(K/32)] int32 (uint32 bit patterns)

    @staticmethod
    def empty(capacity: int, kf_capacity: int = 512, device=None) -> "LineStore":
        i32 = torch.int32
        return LineStore(
            seg=_z((capacity, 6), device=device),
            desc=_z((capacity, 256), torch.int8, device),
            valid=_z(capacity, torch.bool, device),
            n_obs=_z(capacity, i32, device),
            visible=torch.ones(capacity, dtype=i32, device=device),
            found=torch.ones(capacity, dtype=i32, device=device),
            first_kf=_z(capacity, i32, device),
            last_kf=_z(capacity, i32, device),
            obs_bits=_z((capacity, (kf_capacity + 31) // 32), i32, device),
        )


@dataclasses.dataclass(frozen=True)
class KeyFrameStore:
    """Keyframe poses (T_cw) + dense per-feature-slot observation tables."""

    R: torch.Tensor  # [K,3,3]
    t: torch.Tensor  # [K,3]
    v_w: torch.Tensor  # [K,3]
    bg: torch.Tensor  # [K,3]
    ba: torch.Tensor  # [K,3]
    stamp: torch.Tensor  # [K]
    valid: torch.Tensor  # [K] bool
    obs_pt: torch.Tensor  # [K,S] int32
    obs_uvr: torch.Tensor  # [K,S,3]
    obs_sigma2: torch.Tensor  # [K,S]
    obs_stereo: torch.Tensor  # [K,S] bool
    obs_ln: torch.Tensor  # [K,Sl] int32
    obs_l: torch.Tensor  # [K,Sl,3]
    obs_ln_sigma2: torch.Tensor  # [K,Sl]
    covis: torch.Tensor  # [K,K] int32

    @staticmethod
    def empty(capacity: int, slots_pt: int, slots_ln: int, device=None) -> "KeyFrameStore":
        i32 = torch.int32
        return KeyFrameStore(
            R=torch.eye(3, device=device)[None].repeat(capacity, 1, 1),
            t=_z((capacity, 3), device=device),
            v_w=_z((capacity, 3), device=device),
            bg=_z((capacity, 3), device=device),
            ba=_z((capacity, 3), device=device),
            stamp=_z(capacity, device=device),
            valid=_z(capacity, torch.bool, device),
            obs_pt=torch.full((capacity, slots_pt), -1, dtype=i32, device=device),
            obs_uvr=_z((capacity, slots_pt, 3), device=device),
            obs_sigma2=torch.ones((capacity, slots_pt), device=device),
            obs_stereo=_z((capacity, slots_pt), torch.bool, device),
            obs_ln=torch.full((capacity, slots_ln), -1, dtype=i32, device=device),
            obs_l=_z((capacity, slots_ln, 3), device=device),
            obs_ln_sigma2=torch.ones((capacity, slots_ln), device=device),
            covis=_z((capacity, capacity), i32, device),
        )


def alloc_slots(free_mask: torch.Tensor, want_mask: torch.Tensor):
    """Assign free store rows to requested items in order, without host
    round trips. Returns (slot_idx [N] int32, -1 where unassigned; ok [N])."""
    C = free_mask.shape[0]
    ar = torch.arange(C, dtype=torch.int32, device=free_mask.device)
    free_idx = torch.where(free_mask, ar, torch.full_like(ar, C))
    free_sorted, _ = torch.sort(free_idx)
    rank = torch.cumsum(want_mask.to(torch.int32), 0) - 1
    rank = torch.clamp(rank, 0, C - 1)
    slot = free_sorted[rank.long()]
    ok = want_mask & (slot < C) & (rank < torch.sum(free_mask.to(torch.int32)))
    return torch.where(ok, slot, torch.full_like(slot, -1)).to(torch.int32), ok
