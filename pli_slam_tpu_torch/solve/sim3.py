"""Closed-form Sim3/SE3 from 3D-3D correspondences and batched RANSAC
(port of pli_slam_tpu.solve.sim3).

Horn's quaternion method over a batch of 4x4 symmetric eigenproblems (the
largest eigenvector: ops.kernels.eig4, a hand-written kernel on a GPU,
`torch.linalg.eigh` on the CPU), every hypothesis scored against every
correspondence at once, the winner refined on its consensus set. The
eigenvector's sign is free; q and -q give the same rotation. The RANSAC
selects its winner with `ops.indexing.row`, never by indexing with a 0-d
tensor (a host read on CUDA), so it runs inside a captured CUDA graph.

Random draws. `jax.random.choice` cannot be reproduced in torch, so the
RANSAC functions take the drawn indices, and `sample_indices` is the one
sampling function of the port: it draws on a CPU `torch.Generator` seeded
with the integer the reference folds into its `PRNGKey`, and moves the
indices to the probabilities' device. The card and the CPU then draw the
same hypotheses, and a parity test can hand both packages the reference's
own draw.
"""

from __future__ import annotations

import torch

from pli_slam_tpu_torch.ops import lie
from pli_slam_tpu_torch.ops.indexing import row
from pli_slam_tpu_torch.ops.kernels import eig4


def sample_indices(seed: int, probs: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """Indices [*shape] int64 drawn with replacement from the distribution `probs` [N]."""
    p = probs.detach().cpu().to(torch.float64)
    g = torch.Generator().manual_seed(int(seed))
    n = 1
    for d in shape:
        n *= d
    idx = torch.multinomial(p, n, replacement=True, generator=g)
    return idx.reshape(shape).to(probs.device)


def mask_probs(mask: torch.Tensor) -> torch.Tensor:
    """The reference's sampling weights: the mask, normalized; uniform when
    the mask is empty (any draw is then rejected by the caller's inlier
    floor; `jax.random.choice` with an all-zero `p` is undefined)."""
    probs = mask.to(torch.float32)
    total = probs.sum()
    uniform = torch.full_like(probs, 1.0 / probs.shape[0])
    return torch.where(total > 0, probs / torch.clamp(total, min=1e-9), uniform)


def horn_matrix(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Horn's symmetric 4x4 matrix [..., 4, 4] of the weighted sets x, y [..., N, 3]:
    its largest eigenvector is the rotation's quaternion (w, x, y, z)."""
    return _horn_moments(x, y, w)[-1]


def _horn_moments(x, y, w):
    """(normalized weights, the means, the centred sets, Horn's matrix)."""
    wsum = torch.sum(w, dim=-1, keepdim=True)
    wn = w / torch.clamp(wsum, min=1e-9)
    mu_x = torch.sum(x * wn[..., None], dim=-2)
    mu_y = torch.sum(y * wn[..., None], dim=-2)
    xc = x - mu_x[..., None, :]
    yc = y - mu_y[..., None, :]
    S = torch.einsum("...ni,...n,...nj->...ij", xc, wn, yc)
    sxx, sxy, sxz = S[..., 0, 0], S[..., 0, 1], S[..., 0, 2]
    syx, syy, syz = S[..., 1, 0], S[..., 1, 1], S[..., 1, 2]
    szx, szy, szz = S[..., 2, 0], S[..., 2, 1], S[..., 2, 2]
    N = torch.stack(
        [
            torch.stack([sxx + syy + szz, syz - szy, szx - sxz, sxy - syx], -1),
            torch.stack([syz - szy, sxx - syy - szz, sxy + syx, szx + sxz], -1),
            torch.stack([szx - sxz, sxy + syx, -sxx + syy - szz, syz + szy], -1),
            torch.stack([sxy - syx, szx + sxz, syz + szy, -sxx - syy + szz], -1),
        ],
        dim=-2,
    )
    return wn, mu_x, mu_y, xc, yc, N


def horn_alignment(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor, with_scale: bool = True):
    """Weighted closed-form alignment y ~ s R x + t over [..., N, 3] sets.
    Returns (R [..., 3, 3], t [..., 3], s [...])."""
    wn, mu_x, mu_y, xc, yc, N = _horn_moments(x, y, w)
    R = lie.rotation_from_quat(eig4.largest_eigvec(N))  # largest eigenvalue's vector, (w, x, y, z)
    if with_scale:
        Rx = torch.einsum("...ij,...nj->...ni", R, xc)
        num = torch.einsum("...ni,...n,...ni->...", Rx, wn, yc)
        den = torch.einsum("...ni,...n,...ni->...", xc, wn, xc)
        s = num / torch.clamp(den, min=1e-12)
        s = torch.where(torch.isfinite(s) & (s > 1e-3), s, torch.ones_like(s))
    else:
        s = torch.ones(R.shape[:-2], dtype=R.dtype, device=R.device)
    t = mu_y - s[..., None] * torch.einsum("...ij,...j->...i", R, mu_x)
    return R, t, s


def ransac_sim3(x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor, idx: torch.Tensor, inlier_thresh=0.2,
                with_scale: bool = True):
    """Batched-hypothesis RANSAC over x [N,3] -> y [N,3] with validity `mask`
    [N]; `idx` [H,3] are the drawn hypothesis triplets (`sample_indices`
    over `mask_probs(mask)`). Returns (R, t, s, inliers [N] bool, n_inliers)."""
    idx = idx.long()
    H = idx.shape[0]
    R, t, s = horn_alignment(x[idx], y[idx], torch.ones((H, 3), dtype=x.dtype, device=x.device), with_scale)

    pred = s[:, None, None] * torch.einsum("hij,nj->hni", R, x) + t[:, None, :]
    err = torch.linalg.norm(pred - y[None], dim=-1)  # [H, N]
    inl = (err < inlier_thresh) & mask[None, :]
    counts = inl.sum(dim=1)
    best = torch.argmax(counts)

    # refinement on the winning consensus set
    inl_best = row(inl, best)
    R_b, t_b, s_b = horn_alignment(x, y, inl_best.to(x.dtype), with_scale)
    pred_b = s_b * torch.einsum("ij,nj->ni", R_b, x) + t_b
    inliers = (torch.linalg.norm(pred_b - y, dim=-1) < inlier_thresh) & mask
    # if the refinement lost the consensus, keep the raw best
    better = inliers.sum() >= row(counts, best)
    inl_f = torch.where(better, inliers, inl_best)
    return (torch.where(better, R_b, row(R, best)), torch.where(better, t_b, row(t, best)),
            torch.where(better, s_b, row(s, best)), inl_f, inl_f.sum())
