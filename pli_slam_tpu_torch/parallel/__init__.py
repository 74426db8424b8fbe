"""Distribution over `torch.distributed` (port of pli_slam_tpu.parallel).

The reference shards with `shard_map` over a device mesh: poses are
replicated, landmarks (bundle adjustment) or edges (pose-graph
optimization) are sharded, and every cross-shard sum is a `jax.lax.psum`.
Here each shard is a rank of a process group and each `psum` is one
`all_reduce` (`ops.collective.psum`) at the same point; nothing else
crosses ranks.

- `launch.run_ranks` starts a group of ranks (spawned processes, a
  `file://` rendezvous, a hard timeout);
- `dist_ba`: landmark-sharded Schur BA and whole-map (alternating) BA;
- `dist_pgo`: edge-sharded pose-graph optimization.

The backend is always the caller's choice: "gloo" for CPU ranks and for
several ranks sharing one card, "nccl" for one card per rank.
"""
