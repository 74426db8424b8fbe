"""The port's drivers, run as `python3 -m pli_slam_tpu_torch.scripts.<name>`.

They take the reference's `scripts/<name>.py` arguments and write its
outputs (trajectories in the TUM / EuRoC / KITTI formats, `ate.txt`,
`track_times.csv`, plots), and run on the GPU unless `--cpu` is given;
without a GPU and without `--cpu` they exit with an error. Each also writes
`summary.json` (frames, rates, stage means, ATE, keyframes) and takes
`--no-plots`.

  run_euroc       EuRoC (ASL) stereo / stereo-inertial replay
  run_tum         TUM RGB-D replay
  run_kitti       KITTI odometry stereo replay (2000 ORB)
  run_synthetic   the synthetic room sequence
  run_live        an EuRoC folder pushed at camera rate through the live-feed synchronizer
  train_vocab     trained point / line vocabularies from imagery
  diag_ate        frame against keyframe ATE on the bench scene
  profile_stages  utils/profile.py's synchronised stage pass
"""
