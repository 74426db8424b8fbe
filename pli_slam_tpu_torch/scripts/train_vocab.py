"""Train point and line vocabularies from imagery (k-majority centroids + IDF).

  python3 -m pli_slam_tpu_torch.scripts.train_vocab [--euroc DIR | --kitti DIR]
      [--out vocab] [--words 4096] [--line-words 1024] [--frames 200] [--cpu]

Harvests ORB and line (LBD) descriptors from the left images, with the
feature budgets of SlamConfig.euroc_stereo(), on the GPU unless `--cpu`;
without a dataset, from up to 120 frames of a wide trajectory through the
synthetic room. Writes `<out>_pt.npz` and `<out>_ln.npz` (the reference's
format); load them with

  from pli_slam_tpu_torch.worldmap.vocab import TrainedVocabulary
  Tracker(cam, cfg, vocab_pt=TrainedVocabulary.load("vocab_pt.npz"),
          vocab_ln=TrainedVocabulary.load("vocab_ln.npz"))
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from pli_slam_tpu_torch.scripts import common


def harvest(images, cfg, dev) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """Each image's valid ORB and line descriptors (int8 ±1), as numpy."""
    from pli_slam_tpu_torch.ops import lines as line_ops
    from pli_slam_tpu_torch.ops import orb

    pt_sets, ln_sets = [], []
    for i, img in enumerate(images):
        img = torch.as_tensor(img, dtype=torch.float32, device=dev)
        f, ln = orb.extract(img, cfg.orb), line_ops.detect(img, cfg.lines)
        pt_sets.append(f.desc[f.valid].cpu().numpy())
        ln_sets.append(ln.desc[ln.valid].cpu().numpy())
        if i % 20 == 0:
            print(f"harvested {i}", file=sys.stderr, flush=True)
    return pt_sets, ln_sets


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--euroc", help="EuRoC sequence dir (mav0 layout)")
    ap.add_argument("--kitti", help="KITTI odometry sequence dir")
    ap.add_argument("--out", default="vocab")
    ap.add_argument("--words", type=int, default=4096)
    ap.add_argument("--line-words", type=int, default=1024)
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the GPU")
    args = ap.parse_args(argv)
    dev = common.pick_device(args.cpu)

    from pli_slam_tpu_torch.utils.config import SlamConfig
    from pli_slam_tpu_torch.worldmap import vocab as vocab_mod

    cfg = SlamConfig.euroc_stereo()
    if args.euroc:
        from pli_slam_tpu_torch.utils.euroc import EurocSequence

        images = (fr["img_l"] for fr in EurocSequence(args.euroc).frames(stop=args.frames))
    elif args.kitti:
        from pli_slam_tpu_torch.utils.datasets import KittiSequence

        images = (fr["img_l"] for fr in KittiSequence(args.kitti).frames(stop=args.frames))
    else:
        from pli_slam_tpu_torch.ops.camera import Camera
        from pli_slam_tpu_torch.utils import synthetic

        cam = Camera.pinhole(fx=435.2, fy=435.2, cx=367.4, cy=252.2, bf=0.11 * 435.2, width=752, height=480)
        # a wider-roaming trajectory than the bench's, for view diversity
        traj = synthetic.Trajectory(amp=(3.5, 2.5, 1.2), freq=(0.07, 0.09, 0.05), yaw_amp=2.5, yaw_freq=0.04)
        images = (fr["img_l"] for fr in synthetic.make_sequence(cam, min(args.frames, 120), dev, fps=4.0, traj=traj))
    pt_sets, ln_sets = harvest(images, cfg, dev)

    voc_pt = vocab_mod.train_vocabulary(pt_sets, n_words=args.words, iters=10)
    voc_pt.save(f"{args.out}_pt.npz")
    voc_ln = vocab_mod.train_vocabulary(ln_sets, n_words=args.line_words, iters=10)
    voc_ln.save(f"{args.out}_ln.npz")
    print(f"trained {args.out}_pt.npz ({args.words} words, {sum(len(d) for d in pt_sets)} descs) and "
          f"{args.out}_ln.npz ({args.line_words} words, {sum(len(d) for d in ln_sets)} descs)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
