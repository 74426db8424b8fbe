"""Offline map and trajectory plots (port of pli_slam_tpu.utils.viewer).

Map points, map lines, keyframes with the covisibility / spanning / loop
graph and the trajectory (`draw_map`), the per-frame feature overlay
(`draw_frame`) and the aligned estimate against ground truth
(`draw_trajectory_comparison`), written as PNGs with matplotlib's Agg
backend. matplotlib is imported only when a plot is drawn, so the rest of
the port runs without it; the drivers' `--no-plots` skips these calls.
Tensors are read back to the host here.
"""

from __future__ import annotations

import numpy as np


def _np(x) -> np.ndarray:
    """A tensor (on any device) or array as a numpy array."""
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def draw_map(tracker, path: str, title: str = "pli_slam_tpu_torch map",
             with_graph: bool = True, covis_min_weight: int = 15,
             loop_edges: list | None = None):
    """Top-down (x-z) and side (x-y) views of points, lines, keyframes and
    the trajectory, with the covisibility edges above `covis_min_weight`,
    the spanning tree (consecutive keyframe slots) and `loop_edges`
    ([(kf_a, kf_b), ...], drawn highlighted)."""
    plt = _mpl()
    pts = _np(tracker.pstore.x)[_np(tracker.pstore.valid)]
    segs = _np(tracker.lstore.seg)[_np(tracker.lstore.valid)]
    traj = tracker.positions() if tracker.trajectory else np.zeros((0, 3))
    kf_valid = _np(tracker.kstore.valid)
    kR_all = _np(tracker.kstore.R)
    kt_all = _np(tracker.kstore.t)
    centers_all = np.einsum("kji,kj->ki", kR_all, -kt_all)  # -R^T t per slot
    kf_centers = centers_all[kf_valid]
    covis = _np(tracker.kstore.covis)

    fig, axes = plt.subplots(1, 2, figsize=(14, 6))
    for ax, (a, b), name in zip(axes, [(0, 2), (0, 1)], ["top-down (x-z)", "side (x-y)"]):
        if len(pts):
            ax.scatter(pts[:, a], pts[:, b], s=1.0, c="#888888", label=f"points ({len(pts)})")
        for s in segs:
            ax.plot([s[a], s[3 + a]], [s[b], s[3 + b]], c="#2a7fff", lw=0.8)
        if with_graph and kf_valid.sum() >= 2:
            slots = np.nonzero(kf_valid)[0]
            # covisibility edges above the weight floor (upper triangle)
            ii, jj = np.nonzero(np.triu(covis, 1) >= covis_min_weight)
            n_cov = 0
            for i, j in zip(ii, jj):
                if kf_valid[i] and kf_valid[j]:
                    ax.plot([centers_all[i, a], centers_all[j, a]],
                            [centers_all[i, b], centers_all[j, b]],
                            c="#2ca02c", lw=0.5, alpha=0.5)
                    n_cov += 1
            # spanning tree: consecutive keyframe slots (the temporal chain)
            for i, j in zip(slots[:-1], slots[1:]):
                ax.plot([centers_all[i, a], centers_all[j, a]],
                        [centers_all[i, b], centers_all[j, b]],
                        c="#116611", lw=1.0)
            for i, j in (loop_edges or []):
                if kf_valid[i] and kf_valid[j]:
                    ax.plot([centers_all[i, a], centers_all[j, a]],
                            [centers_all[i, b], centers_all[j, b]],
                            c="#ff00ff", lw=2.0, label="loop edge")
        if len(traj):
            ax.plot(traj[:, a], traj[:, b], c="#d62728", lw=1.5, label="trajectory")
        if len(kf_centers):
            ax.scatter(kf_centers[:, a], kf_centers[:, b], s=14, c="#2ca02c", marker="s",
                       label=f"keyframes ({len(kf_centers)})")
        ax.set_title(f"{title} — {name}")
        ax.set_aspect("equal")
        handles, labels = ax.get_legend_handles_labels()
        uniq = dict(zip(labels, handles))
        ax.legend(uniq.values(), uniq.keys(), loc="upper right", fontsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def draw_frame(img, frame_data, path: str, pt_inliers=None, ln_inliers=None):
    """Feature overlay: ORB keypoints, line segments, inliers coloured."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(10, 6))
    ax.imshow(_np(img), cmap="gray", vmin=0, vmax=255)
    feats = frame_data.feats
    uv = _np(feats.uv)
    valid = _np(feats.valid)
    inl = _np(pt_inliers) if pt_inliers is not None else np.zeros(len(uv), bool)
    ax.scatter(uv[valid & ~inl, 0], uv[valid & ~inl, 1], s=6, c="#ffcc00", marker="o")
    ax.scatter(uv[valid & inl, 0], uv[valid & inl, 1], s=8, c="#00cc44", marker="o")
    lv = _np(frame_data.lines.valid)
    lin = _np(ln_inliers) if ln_inliers is not None else np.zeros(len(lv), bool)
    p0 = _np(frame_data.lines.p0)
    p1 = _np(frame_data.lines.p1)
    for i in np.nonzero(lv)[0]:
        c = "#00ccff" if lin[i] else "#ff6666"
        ax.plot([p0[i, 0], p1[i, 0]], [p0[i, 1], p1[i, 1]], c=c, lw=1.2)
    ax.set_xlim(0, _np(img).shape[1])
    ax.set_ylim(_np(img).shape[0], 0)
    ax.set_title(f"features: {int(valid.sum())} pts ({int(inl.sum())} inliers), "
                 f"{int(lv.sum())} lines")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def draw_trajectory_comparison(est: np.ndarray, gt: np.ndarray, path: str, ate: float | None = None):
    """Aligned estimate-vs-ground-truth plot (the evo-style artifact)."""
    from pli_slam_tpu_torch.utils.trajectory import align_umeyama

    plt = _mpl()
    s, R, t = align_umeyama(est, gt)
    aligned = s * est @ R.T + t
    fig, ax = plt.subplots(figsize=(8, 8))
    ax.plot(gt[:, 0], gt[:, 1], c="#444444", lw=1.5, label="ground truth")
    ax.plot(aligned[:, 0], aligned[:, 1], c="#d62728", lw=1.2, label="estimate (aligned)")
    ax.set_aspect("equal")
    title = "trajectory"
    if ate is not None:
        title += f" — ATE RMSE {ate*100:.1f} cm"
    ax.set_title(title)
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
