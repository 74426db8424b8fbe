"""LSH bag-of-words place recognition (port of the LSH half of
pli_slam_tpu.worldmap.vocab).

A descriptor's word is its sign pattern under `n_bits` seeded random
hyperplanes; the planes are drawn with numpy from the same seed as the
reference, so they agree bit for bit. The word bit is `proj >= 0` over a
float32 sum of 256 terms, whose summation order differs between XLA
and torch: a projection within rounding of 0 can flip its bit, so BoW
vectors are compared with a stated tolerance. `TrainedVocabulary` waits
for a later slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pli_slam_tpu_torch.ops.indexing import top_k


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
        return torch.as_tensor(_hyperplanes(self.seed, self.n_bits), device=device)

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
        B = desc.shape[0]
        ids = self.words(desc.reshape(-1, desc.shape[-1]), valid.reshape(-1))
        rows = torch.arange(B, device=desc.device).repeat_interleave(desc.shape[1])
        hist = torch.zeros(B * self.n_words, device=desc.device).index_add(
            0, rows * self.n_words + torch.clamp(ids, min=0).long(), valid.reshape(-1).float()).reshape(B, -1)
        return hist / torch.clamp(torch.linalg.norm(hist, dim=-1, keepdim=True), min=1e-9)


@dataclasses.dataclass(frozen=True)
class BowDatabase:
    hist_pt: torch.Tensor  # [K, W]
    hist_ln: torch.Tensor  # [K, W]
    valid: torch.Tensor  # [K] bool

    @staticmethod
    def empty(capacity: int, n_words: int, device=None) -> "BowDatabase":
        return BowDatabase(
            hist_pt=torch.zeros((capacity, n_words), device=device),
            hist_ln=torch.zeros((capacity, n_words), device=device),
            valid=torch.zeros(capacity, dtype=torch.bool, device=device),
        )

    def add(self, slot: int, bow_pt, bow_ln) -> "BowDatabase":
        hist_pt, hist_ln, valid = self.hist_pt.clone(), self.hist_ln.clone(), self.valid.clone()
        hist_pt[slot] = bow_pt
        hist_ln[slot] = bow_ln
        valid[slot] = True
        return BowDatabase(hist_pt=hist_pt, hist_ln=hist_ln, valid=valid)


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
    member = nb[anchors] | torch.nn.functional.one_hot(anchors, K).to(torch.bool)
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
