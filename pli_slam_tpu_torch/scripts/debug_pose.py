"""Why does the pose solve move away from the true pose? Residuals of one
frame's point matches at the true pose and at the solved pose.

  python3 -m pli_slam_tpu_torch.scripts.debug_pose [--cpu]

Runs the tracker's first frame on the tiny 128x96 synthetic room (lines
off), matches frame 10's features against the point store AT THE TRUE POSE,
and prints the stereo residuals there (|r_uv| and r_ur), after
`solve.gn.solve_pose` from the true pose, the solved pose's translation
error, and how the landmarks' depths compare with the depths that frame
10's own stereo measures.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from pli_slam_tpu_torch.scripts import common


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the GPU")
    args = ap.parse_args(argv)
    dev = common.pick_device(args.cpu)

    from pli_slam_tpu_torch.frontend import step as trk
    from pli_slam_tpu_torch.frontend.tracker import Tracker
    from pli_slam_tpu_torch.ops.camera import Camera
    from pli_slam_tpu_torch.solve import gn
    from pli_slam_tpu_torch.solve import residuals as res
    from pli_slam_tpu_torch.utils import synthetic
    from pli_slam_tpu_torch.utils.config import SlamConfig

    cam = Camera.pinhole(fx=120.0, fy=120.0, cx=64.0, cy=48.0, bf=0.11 * 120.0, width=128, height=96)
    traj = synthetic.Trajectory(amp=(0.5, 0.35, 0.2), freq=(0.15, 0.19, 0.11), yaw_amp=0.25)
    cfg = dataclasses.replace(SlamConfig.tiny_test(), use_lines=False)
    tr = Tracker(cam, cfg, dev)
    frames = list(synthetic.make_sequence(cam, 11, dev, fps=cfg.fps, traj=traj, room_half=2.55))
    fr0, fr10 = frames[0], frames[10]
    tr.process(fr0["img_l"], fr0["img_r"], fr0["t"])
    R_wc = fr0["R_wc"].T @ fr10["R_wc"]
    p_wc = fr0["R_wc"].T @ (fr10["p_w"] - fr0["p_w"])
    R_gt = torch.as_tensor(R_wc.T, dtype=torch.float32, device=dev)
    t_gt = torch.as_tensor(-R_wc.T @ p_wc, dtype=torch.float32, device=dev)
    fd = tr.build_frame(fr10["img_l"], fr10["img_r"])

    pt_idx, pt_ok, _ = trk._match_points_against_store(cam, cfg, fd, R_gt, t_gt, tr.pstore, 15.0)
    ln_idx = torch.full((cfg.lines.n_lines,), -1, dtype=torch.int32, device=dev)
    ln_ok = torch.zeros(cfg.lines.n_lines, dtype=torch.bool, device=dev)
    obs = trk._pose_obs_from_matches(cfg, fd, tr.pstore, tr.lstore, pt_idx, pt_ok, ln_idx, ln_ok)

    m = obs.point_mask.cpu().numpy()
    r, _, xc = res.point_residuals_stereo(cam, R_gt, t_gt, obs.x_w, obs.uvr)
    rn = r.cpu().numpy()[m]
    out = {"n_matches": int(m.sum()), "r_uv_med_gt": float(np.median(np.linalg.norm(rn[:, :2], axis=1))),
           "r_ur_med_gt": float(np.median(rn[:, 2])), "r_ur_mean_gt": float(rn[:, 2].mean()),
           "r_ur_p90_gt": float(np.percentile(np.abs(rn[:, 2]), 90))}
    print("at GT:  |r_uv| med=%.2f  r_ur med=%+.2f  mean=%+.2f  p90(|r_ur|)=%.2f  (%d matches)" % (
        out["r_uv_med_gt"], out["r_ur_med_gt"], out["r_ur_mean_gt"], out["r_ur_p90_gt"], out["n_matches"]))
    result = gn.solve_pose(cam, obs, R_gt, t_gt, cfg.opt)
    r2, _, _ = res.point_residuals_stereo(cam, result.R_cw, result.t_cw, obs.x_w, obs.uvr)
    r2n = r2.cpu().numpy()[m]
    out["r_uv_med_sol"] = float(np.median(np.linalg.norm(r2n[:, :2], axis=1)))
    out["r_ur_med_sol"] = float(np.median(r2n[:, 2]))
    out["t_err_mm"] = float(np.linalg.norm((result.t_cw - t_gt).cpu().numpy()) * 1000)
    print("at SOL: |r_uv| med=%.2f  r_ur med=%+.2f" % (out["r_uv_med_sol"], out["r_ur_med_sol"]))
    print("terr=%.1fmm" % out["t_err_mm"])
    # landmark depth at the true pose against the depth frame 10's stereo measures
    z_lm = xc.cpu().numpy()[m][:, 2]
    uvr = obs.uvr.cpu().numpy()[m]
    z_meas = cam.bf / np.maximum(uvr[:, 0] - uvr[:, 2], 1e-6)
    rel = (z_lm - z_meas) / z_meas
    out["depth_rel_med"] = float(np.median(rel))
    print("landmark-vs-measured depth: med=%+.2f%% p10=%+.1f%% p90=%+.1f%%" % (
        100 * np.median(rel), 100 * np.percentile(rel, 10), 100 * np.percentile(rel, 90)))
    return out


if __name__ == "__main__":
    main()
