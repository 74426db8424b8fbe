"""Bag-of-words place recognition (port of pli_slam_tpu.worldmap.vocab).

`Vocabulary` (the default) is LSH: a descriptor's word is its sign pattern
under `n_bits` seeded random hyperplanes; the planes are drawn with numpy
from the same seed as the reference, so they agree bit for bit. The word
bit is `proj >= 0` over a float32 sum of 256 terms, whose summation order
differs between XLA and torch: a projection within rounding of 0 can flip
its bit, so BoW vectors are compared with a stated tolerance.

`TrainedVocabulary` is a learned flat vocabulary (k-majority centroids and
IDF weights, from `train_vocabulary`, which is numpy as in the reference).
Its word is the centroid of largest dot product, a [N,256]x[256,W] product
of ±1 values. torch has no CUDA int32 matmul, so it runs in float32, which
is exact here (every partial sum is an integer of magnitude <= 256 * 128 *
128 < 2**24); ties go to the lowest word index, as `jnp.argmax`'s do. Files
are the reference's npz (`centroids` int8, `idf` float32), so a vocabulary
saved by either package loads in the other.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pli_slam_tpu_torch.ops.consts import device_const
from pli_slam_tpu_torch.ops.indexing import set_row, top_k


def _hyperplanes(seed: int, n_bits: int, dim: int = 256) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.normal(size=(dim, n_bits)).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class Vocabulary:
    n_bits: int = 12
    seed: int = 17

    @property
    def n_words(self) -> int:
        return 1 << self.n_bits

    def planes(self, device=None) -> torch.Tensor:
        return device_const(("lsh_planes", self.seed, self.n_bits), device, lambda: _hyperplanes(self.seed, self.n_bits))

    def words(self, desc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        proj = torch.matmul(desc.float(), self.planes(desc.device))
        bits = (proj >= 0).to(torch.int32)
        weights = (1 << torch.arange(self.n_bits, dtype=torch.int32, device=desc.device))[None, :]
        ids = torch.sum(bits * weights, dim=-1, dtype=torch.int32)
        return torch.where(valid, ids, torch.full_like(ids, -1))

    def bow(self, desc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        """Normalized word histogram of desc [S,256] where valid [S] -> [n_words]."""
        return self.bow_rows(desc[None], valid[None])[0]

    def bow_rows(self, desc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        """`bow` of every row of a batch: desc [B,S,256], valid [B,S] -> [B, n_words]."""
        ids = self.words(desc.reshape(-1, desc.shape[-1]), valid.reshape(-1)).reshape(valid.shape)
        hist = _histogram_rows(ids, valid, self.n_words)
        return hist / torch.clamp(torch.linalg.norm(hist, dim=-1, keepdim=True), min=1e-9)


def _histogram_rows(ids: torch.Tensor, valid: torch.Tensor, n_words: int) -> torch.Tensor:
    """Word counts of each row: ids [B,S] int32 (-1 invalid), valid [B,S] -> [B, n_words] float32
    (integer-valued, so the float sums are exact in any order)."""
    B, S = ids.shape
    rows = torch.arange(B, device=ids.device).repeat_interleave(S)
    return torch.zeros(B * n_words, device=ids.device).index_add(
        0, rows * n_words + torch.clamp(ids.reshape(-1), min=0).long(), valid.reshape(-1).float()).reshape(B, -1)


@dataclasses.dataclass(frozen=True)
class TrainedVocabulary:
    """Learned flat vocabulary: word centroids from binary k-means
    (k-majority) over training descriptors, and IDF weights. Same
    interface as `Vocabulary` (n_words / words / bow / bow_rows)."""

    centroids: np.ndarray  # [W, 256] int8 ±1
    idf: np.ndarray  # [W] float32
    _dev: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    @property
    def n_words(self) -> int:
        return self.centroids.shape[0]

    def _tensors(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        """(centroids^T [256, W] float32, idf [W]) on `device`, copied there once."""
        key = str(torch.device(device))
        if key not in self._dev:
            self._dev[key] = (torch.as_tensor(self.centroids.astype(np.float32).T.copy(), device=device),
                              torch.as_tensor(self.idf, dtype=torch.float32, device=device))
        return self._dev[key]

    def words(self, desc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        """±1 int8 descriptors [N, 256] -> word ids [N] int32 (-1 invalid)."""
        cent_t, _ = self._tensors(desc.device)
        ids = torch.argmax(torch.matmul(desc.float(), cent_t), dim=-1).to(torch.int32)
        return torch.where(valid, ids, torch.full_like(ids, -1))

    def bow(self, desc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        """IDF-weighted, L2-normalized word histogram of desc [S,256] where valid [S] -> [n_words]."""
        return self.bow_rows(desc[None], valid[None])[0]

    def bow_rows(self, desc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        """`bow` of every row of a batch: desc [B,S,256], valid [B,S] -> [B, n_words]."""
        ids = self.words(desc.reshape(-1, desc.shape[-1]), valid.reshape(-1)).reshape(valid.shape)
        hist = _histogram_rows(ids, valid, self.n_words) * self._tensors(desc.device)[1]
        return hist / torch.clamp(torch.linalg.norm(hist, dim=-1, keepdim=True), min=1e-9)

    def save(self, path: str):
        np.savez_compressed(path, centroids=self.centroids, idf=self.idf)

    @staticmethod
    def load(path: str) -> "TrainedVocabulary":
        d = np.load(path)
        return TrainedVocabulary(centroids=d["centroids"], idf=d["idf"])


def train_vocabulary(desc_sets: list[np.ndarray], n_words: int = 1024, iters: int = 10,
                     seed: int = 0) -> TrainedVocabulary:
    """Binary k-means (k-majority) training, numpy, as in the reference:
    `desc_sets` holds each image's valid ±1 int8 descriptors; a centroid is
    the sign of its members' sum, assignment the largest dot product, and
    an empty cluster is re-seeded from random descriptors. IDF counts the
    training images in which a word occurs. The dot products run as a
    float32 matrix product (exact, as in `words`: numpy's int32 product has
    no BLAS and is ~50x slower) and the members' sums by sorted segments, so
    the result equals the reference's bit for bit."""
    rng = np.random.default_rng(seed)
    all_desc = np.concatenate([d for d in desc_sets if len(d)], axis=0)
    n = all_desc.shape[0]
    cent = all_desc[rng.choice(n, size=min(n_words, n), replace=False)].astype(np.int8)
    if cent.shape[0] < n_words:  # a training set smaller than the vocabulary: pad by resampling
        extra = all_desc[rng.choice(n, size=n_words - cent.shape[0])]
        cent = np.concatenate([cent, extra.astype(np.int8)], axis=0)
    d32 = all_desc.astype(np.float32)
    for _ in range(iters):
        assign = np.argmax(d32 @ cent.astype(np.float32).T, axis=1)
        counts = np.bincount(assign, minlength=n_words)
        used = counts > 0
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])[used]
        sums = np.zeros((n_words, 256), np.int64)
        sums[used] = np.add.reduceat(all_desc[np.argsort(assign, kind="stable")].astype(np.int64), starts, axis=0)
        new = np.where(sums >= 0, 1, -1).astype(np.int8)
        empty = counts == 0
        if empty.any():
            new[empty] = all_desc[rng.choice(n, size=int(empty.sum()))]
        cent = new
    df = np.zeros(n_words, np.float64)
    for d in desc_sets:
        if not len(d):
            continue
        a = np.argmax(d.astype(np.float32) @ cent.astype(np.float32).T, axis=1)
        df[np.unique(a)] += 1
    idf = np.log(max(len(desc_sets), 1) / (1.0 + df)).clip(min=0.0).astype(np.float32)
    if not np.any(idf > 0):  # every word common (tiny training sets): uniform weights
        idf[:] = 1.0
    return TrainedVocabulary(centroids=cent, idf=idf)


@dataclasses.dataclass(frozen=True)
class BowDatabase:
    hist_pt: torch.Tensor  # [K, W]
    hist_ln: torch.Tensor  # [K, W]
    valid: torch.Tensor  # [K] bool

    @staticmethod
    def empty(capacity: int, n_words: int, device=None, n_words_ln: int | None = None) -> "BowDatabase":
        """Line histograms are `n_words_ln` wide (default `n_words`, the reference's only width)."""
        return BowDatabase(
            hist_pt=torch.zeros((capacity, n_words), device=device),
            hist_ln=torch.zeros((capacity, n_words if n_words_ln is None else n_words_ln), device=device),
            valid=torch.zeros(capacity, dtype=torch.bool, device=device),
        )

    def add(self, slot, bow_pt, bow_ln) -> "BowDatabase":
        """Row `slot` (a host int or a 0-d device int) <- the keyframe's histograms."""
        return BowDatabase(hist_pt=set_row(self.hist_pt, slot, bow_pt), hist_ln=set_row(self.hist_ln, slot, bow_ln),
                           valid=set_row(self.valid, slot, True))


def query(db: BowDatabase, bow_pt, bow_ln, exclude_mask, n_best: int = 3, line_weight: float = 0.3,
          covis: torch.Tensor | None = None, group_size: int = 10):
    """Top-n_best candidate keyframes by combined point+line similarity,
    with covisibility-group accumulation when `covis` is given.
    Returns (slots [n_best] int32, scores [n_best])."""
    score = torch.matmul(db.hist_pt, bow_pt) + line_weight * torch.matmul(db.hist_ln, bow_ln)
    score = torch.where(db.valid & ~exclude_mask, score, torch.full_like(score, -1.0))
    if covis is None:
        top_scores, top_idx = top_k(score, n_best)
        return top_idx.to(torch.int32), top_scores

    K = score.shape[0]
    dev = score.device
    s = torch.clamp(score, min=0.0)
    neg = torch.full((), -1.0, device=dev)
    w = torch.where(covis > 0, covis.float(), neg)
    w = torch.where(torch.eye(K, dtype=torch.bool, device=dev), neg, w)
    g = min(group_size, K - 1)
    thr = top_k(w, max(g, 1))[0][:, -1:]
    nb = (w >= torch.clamp(thr, min=1e-9)) & (w > 0)
    acc = s + torch.matmul(nb.to(s.dtype), s)
    acc = torch.where(score > -0.5, acc, torch.full_like(acc, -1.0))
    top_acc, anchors = top_k(acc, n_best)
    member = nb[anchors] | (anchors[:, None] == torch.arange(K, device=dev))  # one_hot checks its range on the host
    member_s = torch.where(member & (score > -0.5)[None], s[None], neg)
    best = torch.argmax(member_s, dim=1)
    best_s = torch.gather(member_s, 1, best[:, None])[:, 0]
    slots = torch.where(top_acc > 0, best, torch.full_like(best, -1))
    ar = torch.arange(n_best, device=dev)
    eq_prev = (slots[:, None] == slots[None, :]) & (ar[None, :] < ar[:, None])
    dup = torch.any(eq_prev & (slots[:, None] >= 0), dim=1)
    slots = torch.where(dup, torch.full_like(slots, -1), slots)
    scores = torch.where(slots >= 0, best_s, torch.full_like(best_s, -1.0))
    return slots.to(torch.int32), scores
