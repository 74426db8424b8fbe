#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py [--baseline DIR]

Phases (each prints one line; any failure raises and exits non-zero):
  1. device  -- a CUDA device must exist; prints nvidia-smi's name and power limit;
  2. build   -- compiles every kernel of the main path from `pli_slam_tpu_torch/csrc/`;
  3. kernels -- each kernel against its plain PyTorch version on the card at
               the main path's shapes (planted matches, duplicate rows, radius
               boundary, ragged store; N=2000 at P=4096 and 16384 for KITTI's
               2000 ORB features) and at shapes that stress its tiling
               (a store below one tile, one row past a chunk, 37 frame rows,
               a store gated out entirely, arbitrary int8 and zero rows, an
               exact duplicate in another tile and chunk), idx, best, second
               and ok exactly equal at both of the main path's acceptance
               settings; the kernel's device time per launch (50 launches in
               one CUDA graph), the whole call and the plain version timed
               with CUDA events;
  3b. the closest-rotation kernel (csrc/rot3.cu: torch.linalg.svd checks its
               status on the host, which a CUDA graph capture refuses)
               against its twin (torch.linalg.svd + det): near rotations
               within 1e-5, general matrices within 1e-4, the sign of det
               exactly equal, at batch 1, 10 and 4096; first ptxas's report
               for it (-Xptxas -v; any stack frame or spill fails); its time
               per launch on the main path's matrices (below) at batch 1 and
               8 and on a rotation perturbed by 1e-4, with the branch and
               sweeps each took; the whole call's, the twin's and one torch.linalg.svd
               call's times; then both against the float64 closest rotation
               of the same float32 input (ROADMAP queue 3 A4), on the main
               path's matrices (preintegration's 16-increment products,
               Gauss-Newton and BA pose updates, formed on the card) and on
               general ones: the kernel's largest error no larger than the
               twin's nor than ROT3_F64; and the launch floor in a graph: a one-element add_,
               50 in a CUDA graph, printed beside each small kernel's time
               per launch after 3d. With `--baseline DIR` (the parent's
               csrc/rot3.cu and csrc/eig4.cu in DIR), 3b and 3c time the
               parent's kernels beside these in turns;
  3c. the largest-eigenvector kernel (csrc/eig4.cu: Horn's 4x4
               eigenproblem; torch.linalg.eigh checks its status on the host,
               which a capture refuses) against its twin (eigh's last column)
               on Horn's matrices of 256 PnP triplets and of a 300-point refit,
               formed on the card, and on general symmetric ones: rotations of
               the two quaternions within EIG4_TOL where the largest
               eigenvalue is simple, and both against float64 there, the
               kernel's largest error no larger than the twin's nor than
               EIG4_F64; ptxas's report as in 3b; its time per
               launch at 256 matrices, the whole call's, the twin's, one
               torch.linalg.eigh call's and the bound from its sweeps;
  3d. the small-SVD kernel (csrc/svd_small.cu: the mono PnP's DLT) against
               its twin (torch.linalg.svd) on the DLT systems [256,12,12] and
               rotation blocks [256,3,3] that `ransac_pnp_dlt` forms on the
               card and on general 12x12 matrices: the null vector within
               SVD_NULL_TOL where the smallest singular value is simple, U Vh
               and S within SVD_BLOCK_TOL of full-rank blocks, and both
               against float64, the kernel no farther; first ptxas's
               registers, stack frame and spills for it from the build
               (-Xptxas -v; any stack frame or spill fails); times as in 3c
               at 256 x 12x12 and 256 x 3x3; then the two-view
               initialization's matrices as `reconstruct_two_views` forms
               them: A^T A of 256 eight-point and 256 four-point hypotheses
               (512 x 9x9; the smallest eigenvector against
               torch.linalg.eigh, its plain version and library call, within
               SVD_NULL_TOL where it is simple, and against float64) and the
               256 F hypotheses (3x3, as the rotation blocks), each timed;
  3e. the conditional IF node's handle kernel (csrc/cond_node.cu: the
               fused steps' keyframe branch; the card's PyTorch has no Python
               route to conditional nodes): a graph whose IF body writes
               1200 floats on a predicate set by a kernel of the graph,
               against its plain version (the host reads the predicate and
               branches) for both values, exactly; the time of one IF node
               with a false predicate (64 in a graph), the host decision's,
               the bound (one byte read); then N_POOL_STREAMS streams taken
               from torch.cuda.Stream (twice what its pool holds), each the
               parent of an IF node's capture, every graph replayed against
               the host's branch for both values, exactly (the body stream is
               the port's own and is never handed out: ROADMAP queue 3 A8);
  3c / 3d on the main path (after phase 8) -- the RANSACs that phases 6a, 6b
               and 8 ran (the loop verifications', the relocalizations' PnP,
               the mono one's DLT; their inputs recorded at the stages' entry)
               solved again with the kernels and with the twins: the winners'
               inlier counts within RANSAC_COUNT_TOL, and the Horn matrices,
               DLT systems and rotation blocks they formed held as in 3c / 3d;
  4. main path -- first its stages on a 128x96 input (build_frame, keyframe
               insertion, one tracking step; IMU preintegration and
               composition, one inertial pose solve, one visual-inertial
               windowed BA) on the card against the CPU, where every kernel
               runs its plain version; then
               the port's `Tracker.process` in streaming mode over the
               40-frame synthetic stereo sequence of bench.py's visual run
               (every frame rendered on the host: the card tracks a CPU's pixels),
               at SlamConfig.euroc_stereo() with loop closing off (752x480,
               1200 ORB x 8 levels, 256 lines, 16384/4096/512 stores), and a
               check that the main path launched every kernel;
  5. stereo-inertial path -- `Tracker.process(..., imu=...)` in streaming mode
               at SlamConfig.euroc_stereo_inertial() with loop closing off and
               bench.py's IMU settings (init after 1.5 s, 16-sample batches),
               same widths, over 52 frames of the same room trajectory with
               200 Hz IMU under ImuNoiseModel.euroc(): the host-orchestrated
               frames, the IMU initialization, then the fused stereo-inertial
               step. Guards on the part that is healthy: initialization
               accepted, gravity within 8 degrees and 15% of the truth, the
               initialized velocity within 0.8 m/s of the truth (it moves at
               2.7 m/s; measured 0.53 m/s off), ATE of the frames up to the
               initialization under 0.10 m. From the first
               keyframe after the initialization, visual-inertial BA drives
               the accelerometer bias and the velocity off on this scene, in
               the reference as in the port (PERF.md, section 6, the stereo-inertial path: the
               reference on these images reaches an ATE of 1.70 m by frame 51
               and loses tracking at frame 57, the port 0.81-0.97 m and frame
               59 or later); so the run stops at 52 frames and the guards on
               the whole run are set from what both packages do: at least 20
               fused frames and one keyframe with visual-inertial BA among
               them, 90% of frames tracked, finite positions, ATE under 2.0 m,
               and at least two gated-match launches per tracked frame,
               counted for this phase alone.
  6. loop closing, relocalization, the Atlas -- SlamConfig.euroc_stereo() as
               published, loop closing on, same widths, streaming mode, with
               bench.py's long-run keyframe budget (kf_max_new_points 256):
               6a. 180 frames of bench.py's flagship trajectory (back at its
               start after 140 frames). No loop candidate reaches the closer
               on these frames, in the reference as in the port (PERF.md,
               section 6, loop closing), so the script then closes the loop between
               the keyframes that ground truth says overlap, the consistency
               counter pre-set (as tests/test_loop_closing_e2e.py does):
               verification, essential-graph PGO, the queued global-BA chunks,
               which 6 more frames and `finalize` run. The closure's
               verification and correction (captured stages) is
               made again from the state before it by a `cuda_graphs=False`
               tracker: the stores, the pose, the loop counters, the queue
               and every kernel's launches bit-identical, the graph side
               under HOST_LAUNCH_LIMIT host kernel launches. Guards: a loop closed,
               the chunk queue empty, 90% of frames tracked, finite positions,
               ATE under 0.10 m before the closure and 0.35 m after it (the
               port's runs: PERF.md, section 6; the reference on its own
               run of these frames: 0.0276 and 0.1290 m; its GBA chunks, like
               the port's, first throw keyframes ~1 m off, and from the same
               map the port's chunks land within 0.021 m of its own: PERF.md,
               section 6, loop closing), two gated-match launches per fused
               frame. Then the frames up to the closure once more on a fresh
               tracker, its pose moved one float32 ulp toward zero after
               frame 1 (`profile.pre_closure_run`): the run must differ from
               the first, and both ATEs before the closure must lie under
               ROUNDING_ATE_BOUND (ROADMAP queue 3 A6: windowed BA's reduced
               system in float32 turned such a difference into centimetres);
               6b. the kidnap of tests/test_reloc_pnp.py (a mapped pose moved
               by (0.45, 0.3, -0.25) m, turned 0.35 rad), up to 6 frames: first
               on 6a's tracker, reported only (at EuRoC's inlier floor of 10
               it tracks the kidnapped view at a wrong pose and declares no
               loss, as the reference does: PERF.md, section 6, loop closing); then,
               as that test raises its floors, on a tracker with floors
               60 / 60 (a wrong pose reached 24-32 inliers here, the true
               one ~600) and recently_lost_sec 3 over the trajectory's first
               20 frames: relocalized, within 0.2 m of the re-track seeded
               with the true pose; its first relocalization made again from
               the state before it by a `cuda_graphs=False` tracker, bit for
               bit as in 6a, and every relocalization frame under graphs
               under HOST_LAUNCH_LIMIT host kernel launches;
               6c. a second tracker (recently_lost_sec 0.15, min_kf_gap 3) over
               the scenario of tests/test_atlas_merge.py: 20 frames, 8 blank
               ones (two maps after), the revisit until the merge (one map),
               4 more frames within 0.5 m of the truth.
               Prints fps and p50/p99 of 6a's ordinary frames and the wall
               time of the loop-closure frame, each GBA chunk, each
               relocalization attempt and the merge frame.
  7. RGB-D through `System.track_rgbd` -- scripts/run_tum.py's deployment as
               published (SlamConfig(sensor="rgbd", width=640, height=480,
               fps=30.0) on TUM3's intrinsics, 1200 ORB x 8 levels, 256 lines,
               16384/4096/512 stores, loop closing on), streaming, over 40
               frames of the synthetic room with depth at 30 fps. Guards: 90%
               of frames tracked, finite positions, ATE under RGBD_ATE_BOUND
               (set from what both packages do on these frames: windowed BA
               throws keyframes off in the reference too), two gated-match
               launches per fused frame
               counted for this phase alone. Then `save_map`, `load_map` into
               a new System in localization mode over the next 5 frames (all
               tracked, the map does not grow), and the trajectory savers'
               files (one line per frame / keyframe);
  8. monocular through `System.track_monocular` -- SlamConfig.euroc_stereo()
               with sensor "mono" (752x480, phase 4's camera, bf unused) over
               40 consecutive frames of phase 4's sequence (the reference
               initializes on consecutive frames at this width). Guards:
               initialized no later than MONO_INIT_MARGIN frames after the
               reference (REF_INIT_MONO), 60% of frames tracked (the
               reference test's floor), Sim(3)-aligned ATE under
               MONO_ATE_BOUND (set from the reference's run on these frames, REF_ATE_MONO),
               two gated-match launches per tracked frame after the
               initialization; then a planted relocalization (the pose set to
               the identity, the state to lost) of the sequence's last frame
               through the mono PnP stage (svd_small): re-tracked, the Sim(3)
               ATE with its pose added under MONO_ATE_BOUND;
  rectifier -- `euroc_rectifier()` on the card against the CPU on a 752x480
               pair, within 1e-3 grey levels, and one call timed.
  9. the dataset ingest path -- each dataset's on-disk layout written from
               the frames above (rendered on the host, quantised to 8 bits as
               a camera's are) into a scratch folder under build/, then the
               port's drivers through their main(), each frame synchronised:
               9a. EuRoC stereo-inertial: phase 5's 52 frames as an ASL folder
               (PNGs with all five row filters, 200 Hz imu0/data.csv, ground
               truth) and a reference-style YAML (phase 5's camera, no
               rectification blocks), `run_euroc --stereo-imu --native-loader
               --config`; the IMU slices read back must equal phase 5's samples;
               phase 5's ATE bounds;
               9b. TUM RGB-D: phase 7's 40 frames (8-bit RGB, 16-bit depth at
               factor 5000, depth stamped 4 ms after its image), `run_tum
               --freiburg 3`; phase 7's ATE bound;
               9c. KITTI stereo: KITTI 00's camera (1241x376, baseline 0.537 m),
               30 frames at 10 fps, 2000 ORB, `run_kitti`; ATE bound set from
               the reference's run of the same folder (REF_ATE_KITTI);
               9d. live: `run_live` on 9a's folder at 20 Hz for 40 frames
               (pushed, delivered and dropped frames printed);
               9e. trained vocabularies: `train_vocab --euroc` on 9a's folder
               (1024 point and line words), their words on the card equal to
               the CPU's, and a Tracker with both over phase 4's first 20
               frames (phase 4's ATE bound), its BoW rows and best loop
               score printed.
               Drivers pass --no-plots when the card has no matplotlib.
 10. the fisheye rig -- TUM-VI's 512x512 Kannala-Brandt8 camera as ORB-SLAM3's
               Examples/Stereo-Inertial/TUM-VI.yaml publishes it (TUM_512), with
               two simplifications: cam0's calibration serves both cameras, and
               the rig is a pure 0.101 m baseline (T_rl a translation); 20 fps,
               200 Hz IMU under ImuNoiseModel.euroc(); otherwise the EuRoC budget
               (1200 ORB x 8 levels, 256 lines, 16384/4096/512 stores, BA window
               8). Every frame is built by build_frame_fisheye_stereo (epipolar-
               gated L<->R matching and DLT triangulation). 10a: sensor "stereo",
               loop closing off, 40 frames on the fused visual step; 10b:
               "stereo_imu" with slice_config_vi()'s IMU settings: host-path frames
               until the IMU initialization, then fused stereo-inertial frames.
               The first pair's SHA-256 must equal FISHEYE0_SHA256; the
               initializations and ATE are held to the reference's run of the
               same frames (REF_FISHEYE*): 10a over the run, 10b on the frame
               before the IMU initialization, whose full inertial BA (damped
               Gauss-Newton without an acceptance test, in both packages) moves
               the map by an amount float32 rounding decides (PERF.md, section
               6, PR 7), so the run after it is held only to stay in the room
               (FISHEYE_VI_ATE_BOUND); the dense L<->R association is timed per
               frame;
 11. mono-inertial through `System.track_monocular(..., imu_batch=)` --
               slice_config_vi() with sensor "mono_imu" (752x480, phase 4's
               camera, 200 Hz noisy IMU): the two-view initialization, the IMU
               initialization with its free scale, then inertial tracking; the
               initialization frames and the Sim(3) ATE on the frame before the
               IMU initialization held to the reference's (REF_MONO_VI: the
               bound is phase 8's, since the two-view initialization draws its
               own RANSAC samples), the scale printed beside the reference's; the
               path-length ratio of the last 20 frames and the ATE over the run
               reported (the reference loses tracking right after the IMU
               initialization on these frames, and so may the port);
 12. RGB-D-inertial through `Tracker.process_rgbd(..., imu=)` -- rgbd_config()
               on rgbd_camera() with sensor "rgbd_imu" and slice_config_vi()'s IMU
               settings, every frame on the host path as in the reference; phase
               5's figures: the IMU initialization's frame held to the
               reference's run (REF_RGBD_VI), ATE before it to phase 7's bound
               on the same deployment, the run after it loosely (2.0 m, phase
               5's: visual-inertial BA drifts, in the reference too). Every
               "vi_ba" stage replay (the IMU initialization's full inertial
               BA, the keyframes' windows, the chunks after its loop closure)
               is also run eagerly on its inputs and must equal the replay
               bit for bit (`check_replays`, its time kept out of the frames').
 13. distribution on `torch.distributed` -- 13a: `utils.production.
               dryrun_multichip` at production shapes (W=32 poses, 16384
               points, 1024 lines, ~124k observations; a 256-node pose graph)
               on 4 gloo ranks that all compute on the card (read from 13c's
               group, which runs every world size): distributed Schur
               BA (cost after 6 iterations below half the cost after 0), whole-
               map BA (12 iterations below 0.6 of the initial robust cost), se3
               PGO (mean translation error below 0.3 of the drift's), every
               rank's replicated poses the same bits; the 1-rank group's poses
               and cost the same bits as the in-process `solve_ba` on the card,
               on that problem and on the same one with 0.2 px of noise on the
               point observations (`production.with_point_noise`: the optimum
               then depends on every shard's observations); on the noisy
               problem 4 ranks against the in-process solve within R
               5e-6, t 3e-5 m and 1e-5 of the cost, while a solve that loses one
               shard lies more than 10x those away (the check can see a
               reduction that drops or averages a shard); 13b: two
               `scripts.run_multihost_ba` processes over a file:// rendezvous
               on the card, the same cost below 1.0; 13c:
               `scripts.bench_scaling`'s rows for world sizes 1/2/4 (per-shard
               rows, a whole Schur solve / 6 and PGO / 12, and one iteration's
               all-reduce bytes with their time issued on their own). The NCCL
               branch needs one card per rank and is not run on one card.
 14. bench.py's flagship path -- SlamConfig.euroc_stereo_inertial() with loop
               closing ON and bench.py's IMU settings and keyframe budget
               (`utils.profile.flagship_config()`), same widths, on phase 6a's
               frames of bench.py's flagship trajectory with their 200 Hz IMU
               under ImuNoiseModel.euroc() (rendered once, in phase 6a):
               14a. the inertial loop closure (`utils.profile.inertial_loop_run`):
               host-path frames, the IMU initialization, 8 fused stereo-inertial
               frames (the visual-inertial drift of ROADMAP.md's queue 3 B1 loses
               this map some 40 frames after the initialization, in the
               reference too), then, as no loop candidate comes this early,
               a closure planted at the newest keyframe, its candidates the
               keyframes at least min_kf_gap (12) older, the ground-truth-nearest
               first, the consistency counter pre-set: verification with the
               IMU initialized, the 4-DoF essential graph, the deferred
               full-inertial-BA sweep queued as "fiba" chunks, which 6 more
               frames and the drain run. Guards: the closure verified with
               imu_ready, only "fiba" chunks queued and the queue drained,
               every keyframe's world z axis in its camera frame turned by at
               most FLAGSHIP_ZAXIS_DEG across the correction (the 4-DoF
               graph's free rotation is about world z, which is gravity only
               in a gravity-aligned world; neither package aligns it:
               ROADMAP queue 3 B13), and each keyframe's gravity direction,
               its roll and pitch, turned by what its own rotation about
               world z gives at gravity's tilt from z, within
               FLAGSHIP_B13_MARGIN_DEG (a port that turns roll or pitch
               further than the reference's B13 does fails here),
               ATE up to the initialization under 0.10 m (phase
               5's), finite positions, 90% of frames tracked, two gated-match
               launches per tracked frame; the largest keyframe position
               error against the truth printed before and after the
               correction and after each chunk, the closure and each chunk
               timed by SyncSpans;
               14b. `scripts/bench.py`'s `run_flagship` (N_BENCH_FLAGSHIP frames:
               through the IMU initialization) and `run_visual`
               (N_BENCH_VISUAL frames of phase 4's sequence, loop closing on)
               in this process: the printed line parses, its keys are bench.py's
               (read from bench.py's source with `ast`), imu_ready is true,
               both ATEs and every time are finite.
  15. CUDA graphs -- on a GPU every fused frame above ran its step as one
               CUDA graph (frontend.graphs.FusedStep: T, the keyframe decision
               on the device, K with and without windowed BA as conditional
               IF nodes; captured at the Tracker's construction), and every
               host-orchestrated frame
               its stages (frontend.graphs.StageProgram: preintegration,
               build, tracking, insertion, windowed BA, BoW, culling, local
               map), the default of `Tracker`. Phase 15 runs phase
               4's 40 frames and phase 5's 52 frames (host-path frames until
               the IMU initialization at frame ~30, fused ones after)
               through a graph Tracker, and their first N_EAGER_VISUAL /
               N_EAGER_VI frames through a `cuda_graphs=False` one: over
               those, every frame's (R, t) and record, every fused frame's
               stats vector and the stores after the last and both kernels'
               launch counts must be bit-identical (the first frame and
               tensor that differ are printed otherwise). Each side prints
               fps, p50, p99 and worst over its fused frames and over its
               host-path frames apart (the captures included), host-issued
               kernel and graph launches per frame and the device's busy
               share over its last N_GRAPH_TRACE frames (traced, CUDA
               activity only, kept out of the timing): exactly one graph
               launch a fused frame with graphs; N_ONE_READ streaming fused
               frames before them traced with their CUDA runtime calls
               (the mark around `process()` alone): one graph launch, no
               device-to-host copy but the stats vector's non-blocking one
               into pinned memory, no stream or device synchronisation and
               at most the wait on the previous frame's stats event
               (`one_read_faults`); no program captured inside any frame of
               the graph runs but `_warm_ahead`'s inertial stages (from the
               capture counts around each frame); the Tracker's construction
               time and warm-ups; the launches of
               phase 5's host-path frames traced one by one (a keyframe and
               a tracking-only frame among them: under graphs at most
               HOST_LAUNCH_LIMIT kernel launches each, or a stage ran
               eagerly), each stage's capture ms, capture ms, graph-pool
               size, peak memory and the kernels' launches; the rare paths'
               stages (relocalization's, captured at a tracker's first lost
               frame, and the loop closer's and the BA chunks' where they
               ran): captures and graph pools.
               bench.py's graphs against eager is `python3 -m
               pli_slam_tpu_torch.scripts.bench [--no-graphs]`.
  16. any number of trackers -- phase 6a's configuration (loop closing on)
               built under graphs N_ROW_TRACKERS times in a row as a
               `Tracker` and three times more through a `System` and two
               `reset()`s, each over phase 6a's first N_ROW_FRAMES frames and
               dropped before the next (ROADMAP queue 3 A8: while the IF
               bodies' stream came from PyTorch's pool, the third such
               tracker in a process failed its capture). Each must capture
               its fused step at construction, track every frame, capture
               nothing inside a frame and, once dropped, leave at most
               TRACKER_LEFT_BOUND bytes of device memory reserved after
               `gc.collect()` and `torch.cuda.empty_cache()`; the bytes each
               left are printed.
The map initializations and the merge (PR 15): in phases 5, 6c, 8, 11
and 12 every call of their stages (INIT_STAGES) under graphs is run again
eagerly on copies of its inputs and must equal the replay bit for bit;
the IMU initialization (5, 11, 12), the mono initialization and the first
mono keyframe after it (8) and the merge (6c) are made again from the
state before them by a `cuda_graphs=False` tracker, bit for bit, both
wall times printed with the graph frame's host launches; the IMU-init
frames, the mono-init frame and every mono keyframe issue at most
HOST_LAUNCH_LIMIT host kernel launches (the merge frame's are printed:
`Atlas.merge_active_into` stays eager, as the reference's `merge_maps`);
each new stage's captures, capture ms and graph pool and the trackers'
warm-ups are printed. Phase 6c traces each revisit frame with a profiler
of its own and reads only the merge frame's trace (one trace of every
frame took 29.7 s to read); phase 8 keeps one trace of every frame (a
profiler a frame cost ~1 s each). A trace is read from the profiler's
results, its frame marks, runtime calls and copies alone (`FrameTrace.
_read`, `_trace_counts`; exporting and parsing phase 8's took ~85 s on an
H100's host, and on streaming fused frames the reader gives the export's
frames, calls and launches).
Every phase that builds a stereo tracker
prints its warm-ups at construction (the fused step's and its first
frames' captures, `fused_warmup_ms`).
Every phase's wall time is printed at the end. Phase 6a keeps its 180
frames: at 148 (past the revisit at 140) its planted closure's chunks left
ATE at 0.3875 m, over its 0.35 m guard (queue 3 B2's divergent GBA depends
on the map), so phase 14 is paid for by 9e's tracker (20 of phase 4's 40
frames) and by sharing phase 6a's rendered frames.
Phases 7, 8 and 9 print fps and p50/p99 (9 also the ingest stage's ms a
frame), and phase 7 the map's save and load times. Phase 4 prints the
SHA-256 of its first frame pair, which must equal the CPU's
(FRAME0_SHA256, held by tests/test_torch_datasets.py). Then one JSON line
describing the kernels (gated_match, closest_rotation, largest_eigvec,
svd_small: launches on every path, per path and per frame, and the N=2000
shapes of KITTI's operating point; phases 10-12's launches and the fisheye
association's time; phase 14's launches; each small kernel's errors
against float64), the nvidia-smi line,
and as the last line {"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
T_START = time.perf_counter()
TIMED_CASES = ("track_r15", "fuse", "kitti_track_r15", "kitti_fuse")
KITTI_FX = 718.856  # KITTI 00's P0 (phase 9c)
TPU_KERNEL = "pli_slam_tpu/ops/pallas/hamming.py:28"
KERNEL_SRC = "pli_slam_tpu_torch/csrc/gated_match.cu"
ROT3_SRC = "pli_slam_tpu_torch/csrc/rot3.cu"
ROT3_REPLACES = "pli_slam_tpu/ops/lie.py:157"  # normalize_rotation: jnp.linalg.svd, lowered by XLA inside the jit
ROT3_TOL = {"near_rotation": 1e-5, "general": 1e-4}  # float32; general: the twin's SVD conditioning
ROT3_F64 = 5e-8  # the closest rotation against float64's: the float64 answer rounded once
ROUNDING_ATE_BOUND = 0.05  # m: phase 6a before the closure, unperturbed and one ulp off (half its guard)
EIG4_F64 = 5e-8  # Horn's unit eigenvector where the largest eigenvalue is simple: the float64 answer rounded once
ROT3_LAUNCHES: dict[str, int] = {}  # closest_rotation launches of each phase's run, by phase function
EIG4_SRC = "pli_slam_tpu_torch/csrc/eig4.cu"
EIG4_REPLACES = "pli_slam_tpu/solve/sim3.py:49"  # horn_alignment: jnp.linalg.eigh, lowered by XLA inside the jit
SVD_SRC = "pli_slam_tpu_torch/csrc/svd_small.cu"
SVD_REPLACES = "pli_slam_tpu/solve/pnp.py:113"  # ransac_pnp_dlt: jnp.linalg.svd of A (:113) and M (:128), in the jit
EIG4_LAUNCHES: dict[str, int] = {}  # largest_eigvec launches of each phase's run, by phase function
SVD_LAUNCHES: dict[str, int] = {}  # svd_small launches of each phase's run, by phase function
COND_SRC = "pli_slam_tpu_torch/csrc/cond_node.cu"
COND_REPLACES = "pli_slam_tpu/frontend/tracker.py:1187"  # the fused step's lax.cond(need_kf, ...), in the jit
COND_LAUNCHES: dict[str, int] = {}  # the IF nodes' handle-kernel launches of each phase's run, by phase function
HBM_RATE = 3.35e12  # bytes/s, H100 SXM (NVIDIA's data sheet)
FP64_RATE = 34e12  # float64 operations/s outside the tensor cores, H100 SXM (NVIDIA's data sheet): the Jacobi kernels'
# the kernels against their twins where the answer is unique: rotations from the quaternions where the largest
# eigenvalue lies more than 1e-2 of |N| above the next (float32 rounding over the gap); the DLT's null vector where
# the smallest singular value lies more than 1e-2 of the largest below the next; U Vh and S of full-rank blocks
EIG4_TOL, SVD_NULL_TOL, SVD_BLOCK_TOL, SIMPLE_GAP = 1e-4, 1e-3, 1e-4, 1e-2
RANSAC_COUNT_TOL = (2, 0.01)  # RANSAC winners' inlier counts, kernel against twin: within 2 or 1 %
RARE_ARGS: dict[str, list] = {"loop_verify": [], "reloc_pnp": []}  # the main path's RANSAC inputs (3c / 3d)
RARE_ARGS_MAX = 6


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Phase 3: gated-match kernel vs its plain version
# ---------------------------------------------------------------------------


def reset_counts() -> None:
    """Every kernel's launch count to 0, just before a phase drives its path."""
    from pli_slam_tpu_torch.ops.kernels import conditional, eig4, hamming, rot3, svd_small

    for m in (hamming, rot3, eig4, svd_small, conditional):
        m.reset_launches()


def kernel_counts() -> tuple[int, int, int, int]:
    """(gated_match, closest_rotation, largest_eigvec, svd_small) launches so far."""
    from pli_slam_tpu_torch.ops.kernels import eig4, hamming, rot3, svd_small

    return hamming.launches, rot3.launches, eig4.launches, svd_small.launches


def warmups(tracker) -> str:
    """A tracker's warm-ups at construction (ms): the fused step's and its
    first frames' captures, its initialization's stages, its loop closer."""
    vals = (("fused step", tracker.fused_warmup_ms), ("init", tracker.init_warmup_ms),
            ("loop closer", tracker.loop_warmup_ms))
    return "warm-ups at construction (ms): " + ", ".join(
        f"{k} {v:.1f}" if v is not None else f"{k} none" for k, v in vals)


def count_small_kernels() -> int:
    """Add the launches since the last reset of closest_rotation, largest_eigvec,
    svd_small and the IF nodes' handle kernel to the calling phase's counts
    (ROT3_LAUNCHES, EIG4_LAUNCHES, SVD_LAUNCHES, COND_LAUNCHES) and return
    closest_rotation's; the counters are 0 again."""
    from pli_slam_tpu_torch.ops.kernels import conditional, eig4, rot3, svd_small

    name, n = sys._getframe(1).f_code.co_name, rot3.launches
    for counts, m in ((ROT3_LAUNCHES, rot3), (EIG4_LAUNCHES, eig4), (SVD_LAUNCHES, svd_small),
                      (COND_LAUNCHES, conditional)):
        counts[name] = counts.get(name, 0) + m.launches
        m.reset_launches()
    return n


def ptxas_logged(name: str, rep: dict) -> dict:
    """Print what ptxas reported for a kernel (-Xptxas -v); the report without its text."""
    log(f"kernels: {name} as ptxas built it (-Xptxas -v): {rep['registers']} registers, {rep['stack_frame']} bytes "
        f"stack frame, {rep['spill_stores']} / {rep['spill_loads']} bytes spill stores / loads, {rep['smem']} bytes "
        f"shared memory: {rep['text']!r}")
    return {key: val for key, val in rep.items() if key != "text"}


def ptxas_checked(name: str, rep: dict) -> dict:
    """`ptxas_logged`, failing on a stack frame or a spill."""
    out = ptxas_logged(name, rep)
    if rep["stack_frame"] or rep["spill_stores"] or rep["spill_loads"]:
        raise AssertionError(f"{name} uses local memory: {rep['text']}")
    return out


@contextlib.contextmanager
def kernel_library(module, lib):
    """The kernel wrapper of `module` launches `lib` (another build of its source) inside the block."""
    kept, module._lib = module._lib, lib
    try:
        yield
    finally:
        module._lib = kept


def parent_sources() -> dict:
    """`--baseline DIR` on the command line: the parent's csrc/rot3.cu and
    csrc/eig4.cu there (e.g. `git show REV:pli_slam_tpu_torch/csrc/rot3.cu`),
    timed beside the kernels in 3b / 3c; {} without it."""
    if "--baseline" not in sys.argv:
        return {}
    from pathlib import Path

    root = Path(sys.argv[sys.argv.index("--baseline") + 1])
    return {name: root / f"{name}.cu" for name in ("rot3", "eig4")}


def in_turns(fns: dict) -> dict:
    """Device time per launch in a CUDA graph (50 launches) of each fn, in
    turns: each once, then each again in reverse order; the mean of the two."""
    from pli_slam_tpu_torch.utils.kernel_bench import graph_ms

    out = {}
    for name in list(fns) + list(fns)[::-1]:
        ms = graph_ms(fns[name])
        out[name] = ms if name not in out else 0.5 * (out[name] + ms)
    return out


def rot3_ops_s(sweeps) -> float:
    """The least time, in s, for the float64 operations rot3's method
    (csrc/rot3.cu) does on matrices whose `sweeps` outputs are `sweeps`:
    ~100 on every matrix for det(A), A^T A and the gate; then a near
    rotation (sweeps >= 0) ~105 for each polar step (E, its largest entry,
    X - X E / 2, the next Gram) and ~21 to finish; any other (-1 - sweeps)
    3 pairs of ~81 a Jacobi sweep and ~176 to finish."""
    ops = 0
    for c in sweeps.tolist():
        ops += 100 + (105 * c + 21 if c >= 0 else 243 * (-1 - c) + 176)
    return ops / FP64_RATE


def rot3_sweeps(sweeps) -> str:
    """How many matrices took each branch of rot3, with how many steps or sweeps."""
    import collections

    polar = collections.Counter(c for c in sweeps.tolist() if c >= 0)
    jac = collections.Counter(-1 - c for c in sweeps.tolist() if c < 0)
    return (f"polar branch {sum(polar.values())} (steps: {dict(sorted(polar.items()))}), Jacobi branch "
            f"{sum(jac.values())} (sweeps: {dict(sorted(jac.items()))})")


def phase_if_node(dev):
    """3e: the conditional IF node's handle kernel (`csrc/cond_node.cu`):
    a graph whose IF body (one write of 1200 floats, as a stats-sized
    buffer is written) runs on a predicate set by a kernel of the graph,
    against its plain version (the host reads the predicate and runs the
    body: the decision the fused frame made on the host before), for both
    values; the time of one IF node with a false predicate in a graph of 64
    (the handle kernel and the node), the plain decision's time, the bound
    (one byte read)."""
    import torch

    from pli_slam_tpu_torch.ops.kernels import conditional

    conditional.ready(dev)
    x = torch.arange(1200, dtype=torch.float32, device=dev)
    out, want = torch.zeros(1200, device=dev), torch.zeros(1200, device=dev)
    flag = torch.zeros((), dtype=torch.int32, device=dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    graphs_ = []
    for n_nodes in (1, 64):
        graph = torch.cuda.CUDAGraph()
        bodies = conditional.BodyPool(dev, graph)
        with torch.cuda.stream(side), torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
            out.zero_()
            for _ in range(n_nodes):
                with conditional.if_node(flag > 0, bodies):
                    torch.add(x, 1.0, out=out)
        graphs_.append(graph)
    torch.cuda.current_stream(dev).wait_stream(side)
    err = 0.0
    for value in (1, 0):
        flag.fill_(value)
        graphs_[0].replay()
        want.zero_()
        conditional.select_reference(flag > 0, lambda: torch.add(x, 1.0, out=want), want)
        torch.cuda.synchronize(dev)
        err = max(err, float((out - want).abs().max()))
    flag.fill_(0)
    s_, e_ = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(5):
        graphs_[1].replay()
    s_.record()
    for _ in range(50):
        graphs_[1].replay()
    e_.record()
    torch.cuda.synchronize(dev)
    ms = s_.elapsed_time(e_) / (50 * 64)
    t0 = time.perf_counter()
    for _ in range(200):
        conditional.select_reference(flag > 0, lambda: torch.add(x, 1.0, out=want), want)
    plain_ms = (time.perf_counter() - t0) * 1e3 / 200
    if err != 0.0:
        raise AssertionError(f"if_node: the graph's IF body against the host's branch: largest difference {err}")
    n_streams, n_handles = if_node_on_pool_streams(dev, x)
    log(f"if_node ({COND_SRC}): an IF body on a predicate set by the graph equals the host's branch for both values; "
        f"{ms:.4f} ms per IF node skipped (handle kernel and node, 64 a graph); the host's decision {plain_ms:.4f} "
        f"ms (a read of the predicate); an IF node captured and replayed right with each of {n_streams} streams "
        f"from torch.cuda.Stream as its parent ({n_handles} distinct handles, none the body stream's)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": 1.0 / HBM_RATE * 1e3,
            "bound_by": "bytes", "library_ms": None}


N_POOL_STREAMS = 64  # streams taken from torch.cuda.Stream in 3e: twice the 32 its pool holds a priority


def if_node_on_pool_streams(dev, x) -> tuple[int, int]:
    """3e: N_POOL_STREAMS streams from `torch.cuda.Stream` (PyTorch's pool
    hands them out round-robin, so every pooled stream comes up at least
    twice), each the parent of an IF node's capture whose body writes its
    own value: every graph must capture, and replay as the host's branch
    for both predicates. A body stream taken from that pool (the port's
    before ROADMAP queue 3 A8 was repaired) would come up as a parent and
    fail its capture. Returns (streams, distinct handles)."""
    import torch

    from pli_slam_tpu_torch.ops.kernels import conditional

    body = conditional.streams(dev).body.cuda_stream
    out, want = torch.zeros_like(x), torch.zeros_like(x)
    flag = torch.zeros((), dtype=torch.int32, device=dev)
    handles = set()
    for k in range(N_POOL_STREAMS):
        parent = torch.cuda.Stream(dev)
        handles.add(parent.cuda_stream)
        if parent.cuda_stream == body:
            raise AssertionError(f"if_node: torch.cuda.Stream handed out the IF bodies' stream {body:#x}")
        parent.wait_stream(torch.cuda.current_stream(dev))
        graph = torch.cuda.CUDAGraph()
        bodies = conditional.BodyPool(dev, graph)
        try:
            with torch.cuda.stream(parent), torch.cuda.graph(graph, stream=parent, capture_error_mode="thread_local"):
                out.zero_()
                with conditional.if_node(flag > 0, bodies):
                    torch.add(x, float(k), out=out)
        except Exception as exc:
            raise AssertionError(f"if_node: the capture on pooled stream {k} ({parent.cuda_stream:#x}) failed: "
                                 f"{exc}") from exc
        torch.cuda.current_stream(dev).wait_stream(parent)
        for value in (1, 0):
            flag.fill_(value)
            graph.replay()
            want.zero_()
            conditional.select_reference(flag > 0, lambda: torch.add(x, float(k), out=want), want)
            if not torch.equal(out, want):
                raise AssertionError(f"if_node: the graph captured on pooled stream {k} ({parent.cuda_stream:#x}) "
                                     f"differs from the host's branch with the predicate {bool(value)}")
    return N_POOL_STREAMS, len(handles)


def phase_rot3(dev):
    """3b: the closest-rotation kernel against its twin (torch.linalg.svd +
    det): near rotations (what the solvers hand it) and general matrices of
    both determinant signs at batch 1 (pose GN, preintegration), 10 (a BA
    window) and 4096; the sign of det exactly equal. ptxas's report for it
    (any stack frame or spill fails). Times per launch in a CUDA graph (50
    launches) on the main path's matrices (`rot3_main_path_matrices`) at
    batch 1 (a pose update) and 8 (a BA window's) and on a rotation
    perturbed by 1e-4, with `--baseline` the parent's kernel beside it in
    turns; the whole call, the twin and one torch.linalg.svd call (the
    library yardstick) at batch 1; the bound from the work this input took;
    the launch floor in a graph. Then the branches and sweeps the main
    path's matrices take and both against float64 (`rot3_accuracy`)."""
    import torch

    from pli_slam_tpu_torch.ops.kernels import rot3
    from pli_slam_tpu_torch.utils.kernel_bench import eager_ms, graph_ms

    ptxas = ptxas_checked("closest_rotation (rot3_kernel)", rot3.ptxas_report())
    g = torch.Generator().manual_seed(7)
    max_err = 0.0
    for n in (1, 10, 4096):
        base = rot3.closest_rotation_reference(torch.randn(n, 3, 3, generator=g))
        for label, x in (("near_rotation", base + 1e-3 * torch.randn(n, 3, 3, generator=g)),
                         ("general", torch.randn(n, 3, 3, generator=g))):
            xd = x.to(dev)
            got, want = rot3.closest_rotation_cuda(xd), rot3.closest_rotation_reference(xd)
            err = float((got - want).abs().max())
            if not err <= ROT3_TOL[label]:
                raise AssertionError(f"closest_rotation: {label} batch {n} differs from its twin by {err}")
            if not torch.equal(torch.sign(torch.linalg.det(got)), torch.sign(torch.linalg.det(want))):
                raise AssertionError(f"closest_rotation: {label} batch {n}: the sign of det differs")
            if label == "near_rotation":
                max_err = max(max_err, err)
            log(f"kernels: closest_rotation {label} batch {n}: max |kernel - twin| {err:.3e} "
                f"(tolerance {ROT3_TOL[label]}), det signs equal")
    perturbed = (rot3.closest_rotation_reference(torch.randn(1, 3, 3, generator=g))
                 + 1e-4 * torch.randn(1, 3, 3, generator=g)).to(dev)
    main = rot3_main_path_matrices(dev, g)
    half = main.shape[0] // 2  # preintegration's products, then the pose updates
    inputs = {"main_path_1": main[half:half + 1].contiguous(), "main_path_8": main[half:half + 8].contiguous(),
              "perturbed_1": perturbed}
    x = inputs["main_path_1"]
    n_sweeps = {}
    for label, xi in inputs.items():
        sweeps = torch.zeros(xi.shape[0], dtype=torch.int32, device=dev)
        rot3.closest_rotation_cuda(xi, sweeps)
        n_sweeps[label] = sweeps.cpu()
    one = torch.zeros(1, device=dev)
    t_call = eager_ms(lambda: rot3.closest_rotation_cuda(x))
    t_plain_a = eager_ms(lambda: rot3.closest_rotation_reference(x))
    t_lib_a = eager_ms(lambda: torch.linalg.svd(x))
    t_floor_a = graph_ms(lambda: one.add_(1.0))
    parent = parent_sources()
    lib_parent = rot3.load(parent["rot3"]) if parent else None
    times = {}
    for label, xi in inputs.items():
        fns = {"kernel": lambda xi=xi: rot3.closest_rotation_cuda(xi)}
        if lib_parent is not None:
            def run_parent(xi=xi):
                with kernel_library(rot3, lib_parent):
                    rot3.closest_rotation_cuda(xi)
            fns["parent"] = run_parent
        times[label] = in_turns(fns)
    t_floor_b = graph_ms(lambda: one.add_(1.0))
    t_lib_b = eager_ms(lambda: torch.linalg.svd(x))
    t_plain_b = eager_ms(lambda: rot3.closest_rotation_reference(x))
    bound = {}
    for label, xi in inputs.items():
        bytes_s, ops_s = 72 * xi.shape[0] / HBM_RATE, rot3_ops_s(n_sweeps[label])
        bound[label] = (max(bytes_s, ops_s) * 1e3, "bytes" if bytes_s >= ops_s else "operations")
    floor = 0.5 * (t_floor_a + t_floor_b)
    out = {"max_abs_err": max_err, "ms": times["main_path_1"]["kernel"], "plain_ms": 0.5 * (t_plain_a + t_plain_b),
           "library_ms": 0.5 * (t_lib_a + t_lib_b), "bound_ms": bound["main_path_1"][0], "call_ms": t_call,
           "bound_by": bound["main_path_1"][1], "sweeps": n_sweeps["main_path_1"].tolist(), "launch_floor_ms": floor,
           "ms_batch8": times["main_path_8"]["kernel"], "bound_ms_batch8": bound["main_path_8"][0],
           "ms_perturbed": times["perturbed_1"]["kernel"], "bound_ms_perturbed": bound["perturbed_1"][0],
           "ptxas": ptxas}
    for label, what in (("main_path_1", "batch 1, a pose update of the main path"),
                        ("main_path_8", "batch 8, a BA window's pose updates"),
                        ("perturbed_1", "batch 1, a rotation perturbed by 1e-4")):
        t = times[label]
        beside = f"; the parent's kernel {t['parent']:.5f} ms (in turns)" if "parent" in t else ""
        log(f"kernels: closest_rotation {what}: kernel {t['kernel']:.5f} ms per launch (50 launches in a CUDA graph, "
            f"{t['kernel'] - floor:+.5f} above the launch floor){beside}; "
            f"{rot3_sweeps(n_sweeps[label])}; bound {bound[label][0]:.3e} ms ({bound[label][1]})")
    if lib_parent is not None:
        out["parent"] = {"ms": times["main_path_1"]["parent"], "ms_batch8": times["main_path_8"]["parent"],
                         "ms_perturbed": times["perturbed_1"]["parent"],
                         "ptxas": ptxas_logged("the parent's rot3_kernel", rot3.ptxas_report(lib_parent))}
    log(f"kernels: closest_rotation batch 1: whole call eager {t_call:.4f} ms, twin {out['plain_ms']:.4f} ms, "
        f"torch.linalg.svd alone {out['library_ms']:.4f} ms; the launch floor in a graph (a one-element add_, 50 in a "
        f"CUDA graph) {floor:.4f} ms")
    out["float64"] = rot3_accuracy(dev, g, main)
    return out


def rot3_main_path_matrices(dev, g, n=512):
    """What the main path hands the closest rotation, formed on the card in
    float32 as the port forms it: preintegration's product of 16 rotation
    increments (ops.imu.preintegrate: gyro up to 2 rad/s over 5 ms samples)
    and Gauss-Newton / BA pose updates (so3_exp(delta) @ R, solve.gn and
    solve.ba, delta up to ~0.03 rad)."""
    import torch

    from pli_slam_tpu_torch.ops import lie
    from pli_slam_tpu_torch.ops.kernels import rot3

    w = (torch.rand(n, 16, 3, generator=g) * 2 - 1) * 2.0 * 0.005
    inc = lie.so3_exp(w.to(dev))
    dR = inc[:, 0]
    for i in range(1, 16):
        dR = lie._mm(dR, inc[:, i])
    R = rot3.closest_rotation_reference(torch.randn(n, 3, 3, generator=g)).to(dev)
    delta = lie.so3_exp((torch.randn(n, 3, generator=g) * 0.01).to(dev))
    return torch.cat([dR, lie._mm(delta, R)])


def rot3_accuracy(dev, g, main) -> dict:
    """ROADMAP queue 3 A4: the kernel and its twin (torch.linalg.svd + det,
    cuSOLVER on the card) against the closest rotation of the same float32
    input in float64, on the main path's matrices `main` and on general
    ones, and the branches and sweeps each took. The kernel's largest error
    must be no larger than the twin's on both."""
    import torch

    from pli_slam_tpu_torch.ops.kernels import rot3

    out = {}
    for label, x in (("main_path", main), ("general", torch.randn(1024, 3, 3, generator=g).to(dev))):
        exact = rot3.closest_rotation_reference(x.double())
        sweeps = torch.zeros(x.shape[0], dtype=torch.int32, device=dev)
        e_kern = float((rot3.closest_rotation_cuda(x, sweeps).double() - exact).abs().max())
        e_twin = float((rot3.closest_rotation_reference(x).double() - exact).abs().max())
        out[label] = {"kernel": e_kern, "twin": e_twin, "sweeps": rot3_sweeps(sweeps.cpu())}
        log(f"kernels: closest_rotation against float64 ({label}, {x.shape[0]} matrices): max error kernel "
            f"{e_kern:.3e} (bound {ROT3_F64}), twin {e_twin:.3e}; {out[label]['sweeps']}")
        if not (e_kern <= e_twin and e_kern <= ROT3_F64):
            raise AssertionError(f"closest_rotation ({label}) lies {e_kern:.3e} from float64, the twin "
                                 f"{e_twin:.3e} (bound {ROT3_F64})")
    return out


# ---------------------------------------------------------------------------
# Phases 3c / 3d: Horn's 4x4 eigenproblem and the PnP DLT's small SVD
# ---------------------------------------------------------------------------


def _simple_top(N):
    """Per matrix of N [n,4,4]: the float64 unit eigenvector of the largest
    eigenvalue and whether that eigenvalue lies more than SIMPLE_GAP of |N|
    above the next (where the eigenvector is unique)."""
    import torch

    w, V = torch.linalg.eigh(N.double().cpu())
    scale = torch.clamp(w.abs().amax(-1), min=1e-30)
    return V[..., :, -1], (w[..., -1] - w[..., -2]) > SIMPLE_GAP * scale


def _sign_free(a, b):
    """Largest difference of unit vectors [n, d] (float64, CPU) up to each one's sign, per vector."""
    import torch

    return torch.minimum((a - b).abs().amax(-1), (a + b).abs().amax(-1))


def eig4_hold(label, N) -> dict:
    """The kernel against its twin (torch.linalg.eigh, cuSOLVER on the card)
    on Horn's matrices N [n,4,4] (on the card): the rotations of their
    quaternions within EIG4_TOL where the largest eigenvalue is simple; then
    both against the float64 eigenvector of the same float32 input there, the
    kernel's largest error no larger than the twin's nor than EIG4_F64."""
    import torch

    from pli_slam_tpu_torch.ops import lie
    from pli_slam_tpu_torch.ops.kernels import eig4

    q_k, q_t = eig4.largest_eigvec_cuda(N), eig4.largest_eigvec_reference(N)
    exact, simple = _simple_top(N)
    n_simple = int(simple.sum())
    d_rot = (lie.rotation_from_quat(q_k) - lie.rotation_from_quat(q_t)).abs().amax((-1, -2)).cpu()
    err = float(d_rot[simple].max()) if n_simple else 0.0
    e_k = float(_sign_free(q_k.double().cpu(), exact)[simple].max()) if n_simple else 0.0
    e_t = float(_sign_free(q_t.double().cpu(), exact)[simple].max()) if n_simple else 0.0
    log(f"kernels 3c: largest_eigvec {label} ({N.shape[0]} matrices, {n_simple} with a simple largest eigenvalue): "
        f"max |R(q_kernel) - R(q_twin)| {err:.3e} (tolerance {EIG4_TOL}); against float64 max |q - q_float64| "
        f"kernel {e_k:.3e}, twin {e_t:.3e}")
    if not err <= EIG4_TOL:
        raise AssertionError(f"largest_eigvec ({label}) differs from its twin by {err} in rotation")
    if not e_k <= min(e_t, EIG4_F64):
        raise AssertionError(f"largest_eigvec ({label}) lies {e_k:.3e} from float64: farther than its twin ({e_t:.3e}) "
                             f"or than {EIG4_F64}")
    return {"max_abs_err": err, "kernel": e_k, "twin": e_t, "n": int(N.shape[0]), "simple": n_simple}


def svd_hold(label, A) -> dict:
    """svd_small against its twin (torch.linalg.svd, cuSOLVER on the card) on
    A [n,k,k] (on the card). DLT systems (k = 12): the null vector (Vh's
    last row, sign-free) within SVD_NULL_TOL where the smallest singular
    value is simple. Rotation blocks (k = 3): U Vh within SVD_BLOCK_TOL and S
    within SVD_BLOCK_TOL of S_max where the block has full rank. Then both
    against float64 on the same float32 input there: the kernel's largest
    error no larger than the twin's."""
    import torch

    from pli_slam_tpu_torch.ops.kernels import svd_small

    k = A.shape[-1]
    u_k, s_k, vt_k = svd_small.svd_cuda(A)
    u_t, s_t, vt_t = svd_small.svd_reference(A)
    u64, s64, vt64 = torch.linalg.svd(A.double().cpu())
    smax = torch.clamp(s64[:, 0], min=1e-30)
    if k == 12:
        ok = (s64[:, -2] - s64[:, -1]) > SIMPLE_GAP * smax
        ex = vt64[:, -1]
        err = _sign_free(vt_k[:, -1].double().cpu(), vt_t[:, -1].double().cpu())
        e_k = _sign_free(vt_k[:, -1].double().cpu(), ex)
        e_t = _sign_free(vt_t[:, -1].double().cpu(), ex)
        tol = SVD_NULL_TOL
    else:
        ok = s64[:, -1] > SIMPLE_GAP * smax
        R64 = u64 @ vt64

        def block_err(u, s, vt, ref, ref_s):
            return torch.maximum((u.double().cpu() @ vt.double().cpu() - ref).abs().amax((-1, -2)),
                                 (s.double().cpu() - ref_s).abs().amax(-1) / smax)

        err = block_err(u_k, s_k, vt_k, (u_t @ vt_t).double().cpu(), s_t.double().cpu())
        e_k, e_t = block_err(u_k, s_k, vt_k, R64, s64), block_err(u_t, s_t, vt_t, R64, s64)
        tol = SVD_BLOCK_TOL
    n_ok = int(ok.sum())
    err, e_k, e_t = (float(x[ok].max()) if n_ok else 0.0 for x in (err, e_k, e_t))
    what = "the null vector" if k == 12 else "U Vh and S / S_max"
    log(f"kernels 3d: svd_small {label} ({A.shape[0]} of {k}x{k}, {n_ok} compared): {what}, max |kernel - twin| "
        f"{err:.3e} (tolerance {tol}); against float64 kernel {e_k:.3e}, twin {e_t:.3e}")
    if not err <= tol:
        raise AssertionError(f"svd_small ({label}) differs from its twin by {err}")
    if not e_k <= e_t:
        raise AssertionError(f"svd_small ({label}) lies farther from float64 than its twin: {e_k:.3e} > {e_t:.3e}")
    return {"max_abs_err": err, "kernel": e_k, "twin": e_t, "n": int(A.shape[0]), "compared": n_ok}


def horn_cases(dev, g) -> list:
    """Horn's matrices as the main path forms them, on the card in float32:
    the PnP's 256 hypotheses (three points lifted by a noisy depth), one
    consensus refit over 300 points, and general symmetric matrices."""
    import torch

    from pli_slam_tpu_torch.ops.kernels import rot3
    from pli_slam_tpu_torch.solve import sim3

    def sets(n, k, noise):
        x = (torch.rand(n, k, 3, generator=g) * 2 - 1) * torch.tensor([2.0, 1.5, 1.0]) + torch.tensor([0.0, 0.0, 3.0])
        R = rot3.closest_rotation_reference(torch.randn(n, 3, 3, generator=g))
        y = x @ R.transpose(-1, -2) + torch.randn(n, 1, 3, generator=g) + noise * torch.randn(n, k, 3, generator=g)
        return sim3.horn_matrix(x.to(dev), y.to(dev), torch.ones(n, k, device=dev))

    B = torch.randn(1024, 4, 4, generator=g)
    return [("pnp_hypotheses", sets(256, 3, 0.02)), ("refit", sets(1, 300, 0.02)),
            ("general", ((B + B.transpose(-1, -2)) / 2).to(dev))]


def dlt_cases(dev, g) -> list:
    """The mono PnP's systems as `ransac_pnp_dlt` forms them on the card: A
    [256,12,12] and the rotation blocks M [256,3,3] of 256 six-point
    hypotheses over a noisy view of 400 points, and general 12x12 matrices."""
    import torch

    from pli_slam_tpu_torch.ops.kernels import svd_small
    from pli_slam_tpu_torch.solve import pnp
    from pli_slam_tpu_torch.utils.profile import slice_camera

    cam = slice_camera()
    x_w = (torch.rand(400, 3, generator=g) * 2 - 1) * torch.tensor([3.0, 2.0, 1.5]) + torch.tensor([0.0, 0.0, 5.0])
    uv = torch.stack([cam.fx * x_w[:, 0] / x_w[:, 2] + cam.cx, cam.fy * x_w[:, 1] / x_w[:, 2] + cam.cy], -1)
    uv = uv + 0.5 * torch.randn(400, 2, generator=g)
    idx = torch.randint(0, 400, (256, 6), generator=g)
    kept = []
    orig = svd_small.svd
    svd_small.svd = lambda A: kept.append(A.clone()) or orig(A)
    try:
        pnp.ransac_pnp_dlt(cam, x_w.to(dev), uv.to(dev), torch.ones(400, dtype=torch.bool, device=dev), idx.to(dev))
    finally:
        svd_small.svd = orig
    return [("dlt_systems", kept[0]), ("rotation_blocks", kept[1]), ("general", torch.randn(256, 12, 12, generator=g)
                                                                                .to(dev))]


def twoview_cases(dev, g) -> list:
    """The two-view initialization's matrices as `reconstruct_two_views`
    forms them on the card: A^T A of its 256 eight-point and 256 four-point
    hypotheses over a noisy view pair of 300 points (one [512,9,9] batch
    here; the path launches the two halves apart), and the 256 F
    hypotheses before their rank-2 projection [256,3,3]."""
    import torch

    from pli_slam_tpu_torch.ops import lie
    from pli_slam_tpu_torch.ops.kernels import svd_small
    from pli_slam_tpu_torch.solve import sim3, twoview
    from pli_slam_tpu_torch.utils.profile import slice_camera

    cam = slice_camera()
    X = (torch.rand(300, 3, generator=g) * 2 - 1) * torch.tensor([3.0, 2.0, 1.5]) + torch.tensor([0.0, 0.0, 5.0])
    R = lie.so3_exp(torch.tensor([0.02, -0.05, 0.01]))
    x2 = X @ R.T + torch.tensor([0.3, 0.02, 0.05])

    def pix(x):
        uv = torch.stack([cam.fx * x[:, 0] / x[:, 2] + cam.cx, cam.fy * x[:, 1] / x[:, 2] + cam.cy], -1)
        return (uv + 0.5 * torch.randn(uv.shape, generator=g)).to(dev)

    mask = torch.ones(300, dtype=torch.bool, device=dev)
    probs = sim3.mask_probs(mask)
    idx_f, idx_h = (sim3.sample_indices(13 + k, probs, (twoview.N_HYPOTHESES, k)) for k in (8, 4))
    kept = {"eig": [], "svd": []}
    orig_eig, orig_svd = svd_small.smallest_eigvec, svd_small.svd
    svd_small.smallest_eigvec = lambda A: kept["eig"].append(A.clone()) or orig_eig(A)
    svd_small.svd = lambda A: kept["svd"].append(A.clone()) or orig_svd(A)
    try:
        twoview.reconstruct_two_views(cam, pix(X), pix(x2), mask, idx_f, idx_h)
    finally:
        svd_small.smallest_eigvec, svd_small.svd = orig_eig, orig_svd
    return [("twoview_AtA", torch.cat(kept["eig"])), ("twoview_F", kept["svd"][0])]


def eigvec_hold(label, M) -> dict:
    """svd_small's smallest eigenvector (Vh's last row) against its plain
    version (torch.linalg.eigh's first eigenvector, cuSOLVER on the card) on
    symmetric positive semi-definite M [n,k,k] (on the card): within
    SVD_NULL_TOL, up to the sign, where the smallest eigenvalue is simple;
    then both against float64 there, the kernel no farther."""
    import torch

    from pli_slam_tpu_torch.ops.kernels import svd_small

    v_k, v_t = svd_small.smallest_eigvec(M), svd_small.smallest_eigvec_reference(M)
    w, V = torch.linalg.eigh(M.double().cpu())
    ok = (w[:, 1] - w[:, 0]) > SIMPLE_GAP * torch.clamp(w.abs().amax(-1), min=1e-30)
    n_ok = int(ok.sum())
    err, e_k, e_t = (float(x[ok].max()) if n_ok else 0.0 for x in (
        _sign_free(v_k.double().cpu(), v_t.double().cpu()), _sign_free(v_k.double().cpu(), V[:, :, 0]),
        _sign_free(v_t.double().cpu(), V[:, :, 0])))
    log(f"kernels 3d: svd_small {label} ({M.shape[0]} of {M.shape[-1]}x{M.shape[-1]}, {n_ok} with a simple smallest "
        f"eigenvalue): the smallest eigenvector, max |kernel - torch.linalg.eigh| {err:.3e} (tolerance "
        f"{SVD_NULL_TOL}); against float64 kernel {e_k:.3e}, eigh {e_t:.3e}")
    if not err <= SVD_NULL_TOL:
        raise AssertionError(f"svd_small ({label}) differs from eigh by {err}")
    if not e_k <= e_t:
        raise AssertionError(f"svd_small ({label}) lies farther from float64 than eigh: {e_k:.3e} > {e_t:.3e}")
    return {"max_abs_err": err, "kernel": e_k, "twin": e_t, "n": int(M.shape[0]), "compared": n_ok}


def _small_times(fn_kernel, fn_call, fn_plain, fn_library) -> dict:
    """Per launch in a CUDA graph (50 launches), the whole call, the twin and
    the library call, in turns (kernel, twin, library, library, twin, kernel)."""
    from pli_slam_tpu_torch.utils.kernel_bench import eager_ms, graph_ms

    k_a, p_a, l_a = graph_ms(fn_kernel), eager_ms(fn_plain), eager_ms(fn_library)
    l_b, p_b, k_b = eager_ms(fn_library), eager_ms(fn_plain), graph_ms(fn_kernel)
    return {"ms": 0.5 * (k_a + k_b), "call_ms": eager_ms(fn_call), "plain_ms": 0.5 * (p_a + p_b),
            "library_ms": 0.5 * (l_a + l_b)}


def phase_eig4(dev):
    """3c: the largest-eigenvector kernel (csrc/eig4.cu) against its twin and
    float64 on Horn's matrices and general ones (`eig4_hold`); ptxas's report
    for it (any stack frame or spill fails); its time at the PnP's 256
    hypotheses, with `--baseline` the parent's kernel beside it in turns, and
    the bound from the sweeps they took."""
    import torch

    from pli_slam_tpu_torch.ops.kernels import eig4

    ptxas = ptxas_checked("largest_eigvec (eig4_kernel)", eig4.ptxas_report())
    g = torch.Generator().manual_seed(12)
    out = {label: eig4_hold(label, N) for label, N in horn_cases(dev, g)}
    N = horn_cases(dev, g)[0][1]
    sweeps = torch.zeros(N.shape[0], dtype=torch.int32, device=dev)
    eig4.largest_eigvec_cuda(N, sweeps=sweeps)
    n_sweeps = int(sweeps.sum())
    times = _small_times(lambda: eig4.largest_eigvec_cuda(N), lambda: eig4.largest_eigvec(N),
                         lambda: eig4.largest_eigvec_reference(N), lambda: torch.linalg.eigh(N))
    parent = parent_sources()
    extra = {"ptxas": ptxas}
    if parent:
        lib_parent = eig4.load(parent["eig4"])

        def run_parent():
            with kernel_library(eig4, lib_parent):
                eig4.largest_eigvec_cuda(N)

        turns = in_turns({"kernel": lambda: eig4.largest_eigvec_cuda(N), "parent": run_parent})
        extra["parent"] = {"ms": turns["parent"], "ms_in_turns": turns["kernel"],
                           "ptxas": ptxas_logged("the parent's eig4_kernel", eig4.ptxas_report(lib_parent))}
        log(f"kernels 3c: largest_eigvec 256 x 4x4 in turns with the parent's kernel: kernel {turns['kernel']:.4f} ms, "
            f"the parent's {turns['parent']:.4f} ms per launch (50 launches in a CUDA graph)")
    # 80 bytes a matrix; a sweep 3 steps of 2 rotations (~35 float64 operations each), the 2x2 block between the
    # pairs (24) and V's rows (48): 426; ~40 more a matrix (the norm, the load, the normalised column)
    bytes_moved, ops = 80 * N.shape[0], 426 * n_sweeps + 40 * N.shape[0]
    bound = max(bytes_moved / HBM_RATE, ops / FP64_RATE) * 1e3
    by = "bytes" if bytes_moved / HBM_RATE >= ops / FP64_RATE else "operations"
    log(f"kernels 3c: largest_eigvec 256 x 4x4: kernel {times['ms']:.4f} ms per launch (50 launches in a CUDA graph), "
        f"whole call eager {times['call_ms']:.4f} ms, twin (torch.linalg.eigh + the last column) "
        f"{times['plain_ms']:.4f} ms, torch.linalg.eigh alone {times['library_ms']:.4f} ms; {n_sweeps} Jacobi sweeps "
        f"in all (at most {int(sweeps.max())} a matrix), bound {bound:.3e} ms ({by})")
    return {**times, "bound_ms": bound, "bound_by": by, "sweeps": n_sweeps, "hold": out,
            "max_abs_err": max(v["max_abs_err"] for v in out.values()), "extra": extra}


def phase_svd_small(dev):
    """3d: the small-SVD kernel (csrc/svd_small.cu) against its twin and
    float64 on the mono PnP's DLT systems and rotation blocks and on general
    12x12 matrices (`svd_hold`), and on the two-view initialization's A^T A
    [512,9,9] (its smallest eigenvector against torch.linalg.eigh,
    `eigvec_hold`) and F hypotheses [256,3,3]; ptxas's registers, stack
    frame and spills for it from the build (none may fall to local memory);
    its times on the DLT systems [256,12,12], the rotation blocks
    [256,3,3] and the two-view's matrices, each with the bound from the
    sweeps they took."""
    import torch

    from pli_slam_tpu_torch.ops.kernels import svd_small

    ptxas = ptxas_checked("svd_small (the most of its 12 instances; the 12x12 one's lines)", svd_small.ptxas_report())
    g = torch.Generator().manual_seed(13)
    cases = dlt_cases(dev, g)
    out = {label: svd_hold(label, A) for label, A in cases}
    timed = {}
    for label, A in cases[:2]:
        count, k = A.shape[0], A.shape[-1]
        sweeps = torch.zeros(count, dtype=torch.int32, device=dev)
        svd_small.svd_cuda(A, sweeps=sweeps)
        n_sweeps = int(sweeps.sum())
        times = _small_times(lambda: svd_small.svd_cuda(A), lambda: svd_small.svd(A),
                             lambda: svd_small.svd_reference(A), lambda: torch.linalg.svd(A))
        # 4 k^2 bytes in, 4 (2 k^2 + k) out a matrix; a pair rotation 18 k + 20 float64 operations, k (k - 1) / 2
        # pairs a sweep, ~4 k^2 more a matrix
        bytes_moved = count * 4 * (3 * k * k + k)
        ops = n_sweeps * (k * (k - 1) // 2) * (18 * k + 20) + count * 4 * k * k
        bound = max(bytes_moved / HBM_RATE, ops / FP64_RATE) * 1e3
        by = "bytes" if bytes_moved / HBM_RATE >= ops / FP64_RATE else "operations"
        log(f"kernels 3d: svd_small {count} x {k}x{k} ({label}): kernel {times['ms']:.4f} ms per launch (50 launches "
            f"in a CUDA graph), whole call eager {times['call_ms']:.4f} ms, twin (torch.linalg.svd) "
            f"{times['plain_ms']:.4f} ms, torch.linalg.svd alone {times['library_ms']:.4f} ms; {n_sweeps} Jacobi "
            f"sweeps in all, bound {bound:.3e} ms ({by})")
        timed[k] = {**times, "bound_ms": bound, "bound_by": by, "sweeps": n_sweeps}
    # the two-view initialization's matrices: A^T A's smallest eigenvector (the plain version and the library call
    # torch.linalg.eigh) and the F hypotheses' SVD
    for label, A in twoview_cases(dev, g):
        k = A.shape[-1]
        out[label] = (eigvec_hold if k == 9 else svd_hold)(label, A)
        sweeps = torch.zeros(A.shape[0], dtype=torch.int32, device=dev)
        svd_small.svd_cuda(A, sweeps=sweeps)
        n_sweeps = int(sweeps.sum())
        if k == 9:  # the function: 4 k^2 bytes in, 4 k out a matrix
            times = _small_times(lambda: svd_small.svd_cuda(A), lambda: svd_small.smallest_eigvec(A),
                                 lambda: svd_small.smallest_eigvec_reference(A), lambda: torch.linalg.eigh(A))
            bytes_moved, plain = A.shape[0] * 4 * (k * k + k), "torch.linalg.eigh's first eigenvector"
        else:
            times = _small_times(lambda: svd_small.svd_cuda(A), lambda: svd_small.svd(A),
                                 lambda: svd_small.svd_reference(A), lambda: torch.linalg.svd(A))
            bytes_moved, plain = A.shape[0] * 4 * (3 * k * k + k), "torch.linalg.svd"
        ops = n_sweeps * (k * (k - 1) // 2) * (18 * k + 20) + A.shape[0] * 4 * k * k
        bound = max(bytes_moved / HBM_RATE, ops / FP64_RATE) * 1e3
        by = "bytes" if bytes_moved / HBM_RATE >= ops / FP64_RATE else "operations"
        log(f"kernels 3d: svd_small {A.shape[0]} x {k}x{k} ({label}): kernel {times['ms']:.4f} ms per launch (50 "
            f"launches in a CUDA graph), whole call eager {times['call_ms']:.4f} ms, plain version ({plain}) "
            f"{times['plain_ms']:.4f} ms, the library call alone {times['library_ms']:.4f} ms; {n_sweeps} Jacobi "
            f"sweeps in all, bound {bound:.3e} ms ({by})")
        timed[label] = {**times, "bound_ms": bound, "bound_by": by, "sweeps": n_sweeps}
    small = timed[3]
    twoview_keys = {f"{key}_{label}": v for label in ("twoview_AtA", "twoview_F") for key, v in timed[label].items()}
    return {**timed[12], "hold": out, "max_abs_err": max(v["max_abs_err"] for v in out.values()),
            "extra": {"ms_3x3": small["ms"], "call_ms_3x3": small["call_ms"], "plain_ms_3x3": small["plain_ms"],
                      "library_ms_3x3": small["library_ms"], "bound_ms_3x3": small["bound_ms"],
                      "bound_by_3x3": small["bound_by"], "sweeps_3x3": small["sweeps"], "shape_3x3": "256 x 3 x 3",
                      **twoview_keys, "shape_twoview_AtA": "512 x 9 x 9", "shape_twoview_F": "256 x 3 x 3",
                      "ptxas": ptxas}}


@contextlib.contextmanager
def check_replays(names, found: list):
    """Every call of the stages `names` under graphs also runs the stage's
    body eagerly on copies of the same inputs when the block ends (so that
    nothing of the check falls inside a frame's trace), its kernel launches
    not counted; each call appends (stage, the first output leaf that
    differs in any bit or None, the check's seconds) to `found`."""
    from pli_slam_tpu_torch.frontend import graphs

    orig = graphs.StageProgram.__call__
    pending = []

    def call(self, *args):
        if self.name not in names or not self.graphs:
            return orig(self, *args)
        before = graphs.tree_clone(args)
        out = orig(self, *args)
        pending.append((self, before, graphs.tree_clone(out)))
        return out

    graphs.StageProgram.__call__ = call
    try:
        yield
    finally:
        graphs.StageProgram.__call__ = orig
        for prog, before, out in pending:
            t0, counts = time.perf_counter(), [m.launches for m in graphs.KERNEL_MODULES]
            want = prog.fn(*before)
            for m, n in zip(graphs.KERNEL_MODULES, counts):
                m.launches = n
            pairs = zip(graphs.tree_leaves(out), graphs.tree_leaves(want), strict=True)
            found.append((prog.name, next((i for i, (a, b) in enumerate(pairs) if not _bits_equal(a, b)), None),
                          time.perf_counter() - t0))


@contextlib.contextmanager
def record_rare_args():
    """Keep clones of the arguments of the first RARE_ARGS_MAX calls of the
    stages `loop_verify` and `reloc_pnp` whose correspondence mask is not
    empty (the warm-ups' are): the main path's RANSAC problems, which
    `phase_small_main_path` solves again with each kernel and its twin.
    Under graphs a stage's Python entry runs at every call; its body only
    at the capture."""
    from pli_slam_tpu_torch.frontend import graphs

    orig = graphs.StageProgram.__call__

    def call(self, *args):
        kept = RARE_ARGS.get(self.name)
        if kept is not None and len(kept) < RARE_ARGS_MAX and bool(args[4 if self.name == "loop_verify" else 3].any()):
            kept.append((self.fn, graphs.tree_clone(args)))
        return orig(self, *args)

    graphs.StageProgram.__call__ = call
    try:
        yield
    finally:
        graphs.StageProgram.__call__ = orig


def phase_small_main_path(dev):
    """3c / 3d on the main path's problems (recorded in phases 6a, 6b, 8 and
    14a): each loop verification's Sim3 / SE3 RANSAC and each
    relocalization's PnP RANSAC (stereo: Horn; mono: the DLT) solved again
    with the kernels and with their twins, the winners' inlier counts within
    RANSAC_COUNT_TOL (where Horn's largest eigenvalue is not simple, e.g.
    collinear triplets, the hypotheses may differ, the consensus not); the
    Horn matrices, DLT systems and rotation blocks they formed held by
    `eig4_hold` / `svd_hold`."""
    import torch

    from pli_slam_tpu_torch.ops.kernels import eig4, svd_small
    from pli_slam_tpu_torch.solve import pnp, sim3

    mats = {"horn": [], "svd12": [], "svd3": []}
    orig_eig, orig_svd = eig4.largest_eigvec, svd_small.svd

    def solve(fn, args, twin):
        if twin:
            eig4.largest_eigvec, svd_small.svd = eig4.largest_eigvec_reference, svd_small.svd_reference
        else:
            eig4.largest_eigvec = lambda N: mats["horn"].append(N.reshape(-1, 4, 4)) or orig_eig(N)
            svd_small.svd = lambda A: mats[f"svd{A.shape[-1]}"].append(A) or orig_svd(A)
        try:
            if fn.func.__name__ == "loop_verify":
                _, _, with_scale = fn.args
                x, y, m, thresh, hyp = args[2:7]
                return int(sim3.ransac_sim3(x, y, m, hyp, inlier_thresh=thresh, with_scale=with_scale)[4])
            cam, _, mono = fn.args[:3]
            frame, x_store, idx, okm, hyp, _ = args
            x_w = x_store[idx.long()]
            if mono:
                return int(pnp.ransac_pnp_dlt(cam, x_w, frame.feats.uv, okm, hyp, inlier_px=8.0, min_inliers=12)[3])
            return int(pnp.ransac_pnp(cam, x_w, frame.feats.uv, frame.depth, okm, hyp, inlier_px=8.0,
                                      min_inliers=12)[3])
        finally:
            eig4.largest_eigvec, svd_small.svd = orig_eig, orig_svd

    counts = []
    for name, calls in RARE_ARGS.items():
        for fn, args in calls:
            n_k, n_t = solve(fn, args, False), solve(fn, args, True)
            counts.append((name + ("_mono" if name == "reloc_pnp" and fn.args[2] else ""), n_k, n_t))
            if abs(n_k - n_t) > max(RANSAC_COUNT_TOL[0], RANSAC_COUNT_TOL[1] * max(n_k, n_t)):
                raise AssertionError(f"{name}: the RANSAC winner's inliers with the kernels {n_k}, with the twins {n_t}")
    log(f"kernels 3c / 3d, the main path's RANSACs (stage, inliers with the kernels, with the twins): {counts}")
    if not any(c[0] == "loop_verify" for c in counts) or not any(c[0] == "reloc_pnp_mono" for c in counts):
        raise AssertionError(f"the main path's RANSACs recorded: {[c[0] for c in counts]}")
    out = {}
    for key, hold, label in (("horn", eig4_hold, "main path (Horn's matrices of the RANSACs above)"),
                             ("svd12", svd_hold, "main path (the mono PnP's DLT systems)"),
                             ("svd3", svd_hold, "main path (the mono PnP's rotation blocks)")):
        if mats[key]:
            out[key] = hold(label, torch.cat(mats[key]))
    if set(out) != {"horn", "svd12", "svd3"}:
        raise AssertionError(f"the main path's matrices held: {sorted(out)}")
    reset_counts()  # the launches above compare the kernels with their twins
    return {"ransac_counts": counts, **out}


def _special_cases(rng):
    """Inputs that stress the kernel's tiling rather than the main path's
    shapes: (label, arrays, radius, what must hold besides equality)."""
    import numpy as np

    from pli_slam_tpu_torch.utils.kernel_bench import match_case

    out = [
        ("small_store", match_case(rng, 1200, 100, 15.0, n_dup=0), 15.0, None),  # a store smaller than one tile
        # one row past a chunk boundary: the kernel cuts 4096 rows into 16 chunks of 256, 256 rows into 2 of 128
        ("past_chunk", match_case(rng, 1200, 4097, 15.0), 15.0, None),
        ("past_small_chunk", match_case(rng, 130, 257, 15.0, n_dup=0), 15.0, None),
        ("small_n", match_case(rng, 37, 4096, 15.0, n_dup=16), 15.0, None),  # fewer frame rows than one tile
    ]
    fdesc, fuv, fvalid, sdesc, suv, svalid = match_case(rng, 1200, 4096, 15.0)
    out.append(("all_gated", (fdesc, fuv, fvalid, sdesc, suv + np.float32(5000.0), svalid), 15.0, "none"))
    # arbitrary int8 values and rows of zeros on both sides: distances negative and half-integer
    fdesc, fuv, fvalid, sdesc, suv, svalid = match_case(rng, 1200, 4096, 45.0)
    fdesc = rng.integers(-128, 128, size=fdesc.shape).astype(np.int8)
    sdesc = rng.integers(-128, 128, size=sdesc.shape).astype(np.int8)
    fdesc[::7], sdesc[::5] = 0, 0
    out.append(("any_int8", (fdesc, fuv, fvalid, sdesc, suv, svalid), 45.0, None))
    # every feature's exact copy at store row i and again 8 tiles of 128 rows on: another tile and another chunk
    fdesc, fuv, fvalid, sdesc, suv, svalid = match_case(rng, 1200, 4096, 15.0, n_dup=0)
    far = 8 * 128 * -(-1200 // (8 * 128))
    sdesc[:1200], sdesc[far:far + 1200] = fdesc, fdesc
    suv[:1200], suv[far:far + 1200] = fuv, fuv
    svalid[:1200], svalid[far:far + 1200] = True, True
    out.append(("far_duplicate", (fdesc, fuv, fvalid, sdesc, suv, svalid), 15.0, "lowest"))
    return out


def phase_kernels(dev):
    import numpy as np
    import torch

    from pli_slam_tpu_torch.ops.kernels import hamming
    from pli_slam_tpu_torch.utils.kernel_bench import eager_ms, graph_ms, match_case

    main_cases = [  # (label, N, P, radius): the main path's calls; KITTI's 2000 ORB (phase 9c) at fx 718.856
        ("track_r15", 1200, 4096, 15.0),
        ("track_wide_r45", 1200, 4096, 45.0),
        ("track_r6", 1200, 4096, 6.0),
        ("fuse", 1200, 16384, float(np.float32(0.05) * np.float32(435.2))),
        ("ragged_store", 1200, 4096 + 77, 15.0),
        ("kitti_track_r15", 2000, 4096, 15.0),
        ("kitti_fuse", 2000, 16384, float(np.float32(0.05) * np.float32(KITTI_FX))),
    ]
    rng = np.random.default_rng(0)
    cases = [(label, match_case(rng, n, p, radius), radius, None) for label, n, p, radius in main_cases]
    cases += _special_cases(rng)
    max_err = 0.0
    times = {}
    for label, arrays, radius, expect in cases:
        fdesc, fuv, fvalid, sdesc, suv, svalid = args = tuple(torch.as_tensor(a, device=dev) for a in arrays)
        n, p = fdesc.shape[0], sdesc.shape[0]
        r_dev = torch.tensor(radius, dtype=torch.float32, device=dev)
        p_idx, p_best, p_second = hamming.gated_match_reference(*args, r_dev)
        # the main path's two settings: tracking (100, 0.9) and the fuse (64, no ratio test)
        for max_dist, ratio in ((100.0, 0.9), (64.0, 1.0)):
            k_idx, k_best, k_second, k_ok = hamming.gated_match_cuda(*args, r_dev, max_dist, ratio)
            w_idx, w_best, w_ok = hamming.gated_match(*args, radius, max_dist, ratio)  # a Python-float radius
            torch.cuda.synchronize()
            if not (torch.equal(k_idx, p_idx) and torch.equal(w_idx, p_idx)):
                raise AssertionError(f"{label}: idx differs in {(k_idx != p_idx).sum().item()} rows")
            err = max((k_best - p_best).abs().max().item(), (k_second - p_second).abs().max().item(),
                      (w_best - p_best).abs().max().item())
            if err != 0.0:
                raise AssertionError(f"{label}: best/second differ by up to {err}")
            ok_ref = hamming.accept_reference(fvalid, p_idx, p_best, p_second, max_dist, ratio)
            if not (torch.equal(k_ok, ok_ref) and torch.equal(w_ok, ok_ref)):
                raise AssertionError(f"{label}: ok differs at max_dist {max_dist}, ratio {ratio}")
            max_err = max(max_err, err)
        n_tie = int((k_second == k_best).sum().item())
        n_match = int((k_idx >= 0).sum().item())
        if expect == "none" and (n_match or not bool(((k_best == 1e9) & (k_second == 1e9)).all())):
            raise AssertionError(f"{label}: {n_match} rows matched in a store gated out entirely")
        if expect == "lowest":
            rows = torch.arange(n, device=dev, dtype=torch.int32)
            if not (torch.equal(k_idx[fvalid], rows[fvalid]) and bool((k_second[fvalid] == 0).all())):
                raise AssertionError(f"{label}: the lower of two exact copies must win with second == best == 0")
        if label in TIMED_CASES:
            max_dist, ratio = (64.0, 1.0) if label.endswith("fuse") else (100.0, 0.9)
            t_plain_a = eager_ms(lambda: hamming.gated_match_reference(*args, r_dev))
            t_kern_a = graph_ms(lambda: hamming.gated_match_cuda(*args, r_dev, max_dist, ratio))
            t_call = eager_ms(lambda: hamming.gated_match(*args, r_dev, max_dist, ratio))
            t_kern_b = graph_ms(lambda: hamming.gated_match_cuda(*args, r_dev, max_dist, ratio))
            t_plain_b = eager_ms(lambda: hamming.gated_match_reference(*args, r_dev))
            times[label] = (0.5 * (t_kern_a + t_kern_b), 0.5 * (t_plain_a + t_plain_b), t_call)
            log(f"kernels: {label} N={n} P={p} kernel {times[label][0]:.4f} ms per launch (50 launches in a CUDA "
                f"graph), whole call {t_call:.4f} ms (eager), plain {times[label][1]:.4f} ms")
        log(f"kernels: {label} N={n} P={p} r={radius:.3f}: idx/best/second/ok exactly equal "
            f"({n_match} matched rows, {n_tie} rows with second == best)")
    return max_err, times


# ---------------------------------------------------------------------------
# Phase 4: the port's main path
# ---------------------------------------------------------------------------


def _to(x, dev):
    """A dataclass tree of tensors moved to `dev`."""
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: _to(getattr(x, f.name), dev) for f in dataclasses.fields(x)})
    return x.to(dev)


def phase_small_reference(dev):
    """The main path's stages on a small input, on the card against the CPU
    (where every kernel runs its plain version), each from identical input:
    build_frame on a 128x96 stereo pair, keyframe insertion, and one
    tracking step. Whole runs are not compared: at this size the tracker's
    later frames are chaotic (a one-line difference can flip a pose
    between two solutions), while each stage is not. Tolerances: 99% of
    keypoints and 99.5% of their descriptor bits identical (float32 sums
    run in another order on the card), stores and poses within 1e-4."""
    import torch

    from pli_slam_tpu_torch import SlamConfig
    from pli_slam_tpu_torch.frontend import step
    from pli_slam_tpu_torch.frontend.frame import build_frame
    from pli_slam_tpu_torch.ops.camera import Camera
    from pli_slam_tpu_torch.utils import synthetic
    from pli_slam_tpu_torch.utils.profile import loop_off
    from pli_slam_tpu_torch.worldmap import stores

    cfg = loop_off(SlamConfig.tiny_test())
    cam = Camera.pinhole(fx=120.0, fy=120.0, cx=64.0, cy=48.0, bf=0.11 * 120.0, width=128, height=96)
    traj = synthetic.Trajectory(amp=(0.5, 0.35, 0.2), freq=(0.15, 0.19, 0.11), yaw_amp=0.25)
    seq = list(synthetic.make_sequence(cam, 2, "cpu", fps=cfg.fps, traj=traj, room_half=2.55))
    frames = [build_frame(cam, cfg, f["img_l"], f["img_r"]) for f in seq]
    f0c = frames[0]
    f0g = build_frame(cam, cfg, seq[0]["img_l"].to(dev), seq[0]["img_r"].to(dev))
    same = (f0g.feats.uv.cpu() == f0c.feats.uv).all(-1) & (f0g.feats.valid.cpu() == f0c.feats.valid)
    bits = (f0g.feats.desc.cpu() == f0c.feats.desc)[same & f0c.feats.valid].float().mean().item()
    if same.float().mean().item() < 0.99 or bits < 0.995:
        raise AssertionError(f"build_frame: {same.float().mean().item():.4f} keypoints, {bits:.4f} bits agree")

    def insert(device):
        f = _to(frames[0], device)
        n, nl = f.feats.uv.shape[0], f.lines.angle.shape[0]
        m = cfg.map
        return step.insert_keyframe(
            cam, cfg, f, torch.eye(3, device=device), torch.zeros(3, device=device), 0.0,
            torch.full((n,), -1, dtype=torch.int32, device=device), torch.zeros(n, dtype=torch.bool, device=device),
            torch.full((nl,), -1, dtype=torch.int32, device=device), torch.zeros(nl, dtype=torch.bool, device=device),
            0, stores.PointStore.empty(m.max_points, device=device), stores.LineStore.empty(m.max_lines, device=device),
            stores.KeyFrameStore.empty(m.max_keyframes, cfg.orb.n_features, cfg.lines.n_lines, device))

    (ps, ls, ks, n_new), out_g = insert("cpu"), insert(dev)
    if (int(n_new) != int(out_g[3]) or not torch.equal(out_g[0].valid.cpu(), ps.valid)
            or (out_g[0].x.cpu() - ps.x).abs().max().item() > 1e-4):
        raise AssertionError("insert_keyframe: card and CPU stores differ")

    local = step._local_map_ids(cfg, ks, ps, 0)
    eye, zero, wide = torch.eye(3), torch.zeros(3), torch.tensor(True)
    rc = step.track_step(cam, cfg, frames[1], eye, zero, ps, ls, wide, local)
    rg = step.track_step(cam, cfg, _to(frames[1], dev), eye.to(dev), zero.to(dev), _to(ps, dev), _to(ls, dev),
                         wide.to(dev), local.to(dev))
    err = max((rg[0].cpu() - rc[0]).abs().max().item(), (rg[1].cpu() - rc[1]).abs().max().item())
    if err > 1e-4 or int(rg[6]) != int(rc[6]) or not torch.equal(rg[2].cpu(), rc[2]):
        raise AssertionError(f"track_step: pose diff {err}, inliers {int(rg[6])} vs {int(rc[6])}")
    log(f"reference: 128x96 input, card vs CPU plain path: {same.float().mean().item():.4f} of keypoints and "
        f"{bits:.4f} of descriptor bits equal, keyframe stores equal, tracking pose diff {err:.2e}, "
        f"{int(rc[6])} inliers on both")
    phase_small_reference_inertial(dev, cam, traj)


def phase_small_reference_inertial(dev, cam, traj):
    """The inertial stages on the 128x96 scene, on the card against the CPU,
    each from identical input. A CPU tracker (stereo-inertial, IMU
    initialization after 1.0 s and 5 keyframes) runs 24 frames, which takes
    it through the initialization into the fused step; from its state and the
    next frame: `preintegrate` + `compose` (deltas within 1e-5, covariance
    1e-4 relative), one `solve_pose_inertial` on the CPU's own matches (pose
    within 1e-4, velocity 1e-3 m/s, biases 1e-3, the same inliers but for at
    most two), and one `local_inertial_ba` over the last keyframes (poses
    within 2e-3, velocities 2e-2 m/s: visual-inertial BA on this small map
    is as ill-conditioned in float32 as the visual one, and the card's
    sums run in another order)."""
    import torch

    from pli_slam_tpu_torch import SlamConfig
    from pli_slam_tpu_torch.frontend import step
    from pli_slam_tpu_torch.frontend.frame import build_frame
    from pli_slam_tpu_torch.frontend.tracker import Tracker
    from pli_slam_tpu_torch.ops import imu as imu_ops
    from pli_slam_tpu_torch.solve import inertial as inr
    from pli_slam_tpu_torch.utils import synthetic
    from pli_slam_tpu_torch.utils.profile import loop_off

    cfg = loop_off(SlamConfig.tiny_test())
    cfg = dataclasses.replace(cfg, sensor="stereo_imu", imu=dataclasses.replace(
        cfg.imu, init_time_sec=1.0, max_samples_per_frame=16, init_min_kfs=5))
    tr = Tracker(cam, cfg, "cpu")
    seq = list(synthetic.make_sequence(cam, 25, "cpu", fps=cfg.fps, traj=traj, room_half=2.55))
    for fr in seq[:24]:
        tr.process(fr["img_l"], fr["img_r"], fr["t"],
                   imu={"gyro": fr["imu_gyro"], "acc": fr["imu_acc"], "stamps": fr["imu_stamps"]})
    if not (tr.imu_ready and tr._vi_fused_active):
        raise AssertionError("the small stereo-inertial run did not reach the fused step")
    fr = seq[24]
    packed = tr._imu_batch_arrays({"gyro": fr["imu_gyro"], "acc": fr["imu_acc"], "stamps": fr["imu_stamps"]},
                                  packed=True)

    def preint(device):
        b, bg, ba = packed.to(device), tr.bg.to(device), tr.ba.to(device)
        p = imu_ops.preintegrate(b[:, 0:3], b[:, 3:6], b[:, 6], b[:, 7] > 0.5, bg, ba, cfg.imu)
        return p, imu_ops.compose(_to(tr._preint_acc, device), p)

    (pc, ac), (pg, ag) = preint("cpu"), preint(dev)
    for name in ("dt", "dR", "dV", "dP", "JRg", "JVg", "JVa", "JPg", "JPa"):
        for c, g in ((pc, pg), (ac, ag)):
            if (getattr(g, name).cpu() - getattr(c, name)).abs().max().item() > 1e-5:
                raise AssertionError(f"preintegrate/compose: {name} differs between card and CPU")
    cov_err = ((ag.cov.cpu() - ac.cov).abs().max() / ac.cov.abs().max()).item()
    if cov_err > 1e-4:
        raise AssertionError(f"compose: covariance differs by {cov_err} of its largest entry")

    frame = build_frame(cam, cfg, fr["img_l"], fr["img_r"])
    prev = inr.body_state_from_camera(tr.R, tr.t, tr.v_w, tr.bg, tr.ba, tr.ext)
    Rp, vp, pp = imu_ops.predict_state(prev.R_wb, prev.v_w, prev.p_w, pc, tr.bg, tr.ba, tr.gravity_w)
    init = inr.BodyState(R_wb=Rp, p_w=pp, v_w=vp, bg=tr.bg, ba=tr.ba)
    R0, t0 = inr.camera_pose(init, tr.ext)
    rad = float(cfg.match.search_radius_px)
    pt_idx, pt_ok, _ = step._match_points_against_store(cam, cfg, frame, R0, t0, tr.pstore, rad, tr._local_pt)
    ln_idx, ln_ok, _ = step._match_lines_against_store(cam, cfg, frame, R0, t0, tr.lstore, rad)
    obs = step._pose_obs_from_matches(cfg, frame, tr.pstore, tr.lstore, pt_idx, pt_ok, ln_idx, ln_ok)

    def solve(device):
        return inr.solve_pose_inertial(cam, _to(tr.ext, device), _to(obs, device), _to(pc, device), _to(prev, device),
                                       _to(init, device), cfg.opt, cfg.imu, gravity_w=tr.gravity_w.to(device))

    (sc, in_c, _, n_c), (sg, in_g, _, n_g) = solve("cpu"), solve(dev)
    errs = {k: (getattr(sg, k).cpu() - getattr(sc, k)).abs().max().item() for k in ("R_wb", "p_w", "v_w", "bg", "ba")}
    if (max(errs["R_wb"], errs["p_w"]) > 1e-4 or max(errs["v_w"], errs["bg"], errs["ba"]) > 1e-3
            or int((in_g.cpu() != in_c).sum()) > 2):
        raise AssertionError(f"solve_pose_inertial: card and CPU differ: {errs}, inliers {int(n_g)} vs {int(n_c)}")

    n_kf, W = tr.n_kf, cfg.opt.local_ba_window
    window = torch.clamp(torch.arange(n_kf - W, n_kf, dtype=torch.int32), min=0)
    fixed = (torch.arange(W) < 2) | torch.cat([torch.zeros(1, dtype=torch.bool), window[1:] <= window[:-1]])
    imu_mask = tr._pints.valid[window[1:].long()] & (window[1:] == window[:-1] + 1)

    def viba(device):
        ks, _, _ = step.local_inertial_ba(
            cam, cfg, _to(tr.kstore, device), _to(tr.pstore, device), _to(tr.lstore, device), window.to(device),
            fixed.to(device), _to(tr._pints.gather(window[1:]), device), imu_mask.to(device),
            tr.gravity_w.to(device), _to(tr.ext, device))
        return ks

    kc, kg = viba("cpu"), viba(dev)
    e_pose = max((kg.R.cpu() - kc.R).abs().max().item(), (kg.t.cpu() - kc.t).abs().max().item())
    e_v = (kg.v_w.cpu() - kc.v_w).abs().max().item()
    moved = (kc.t - tr.kstore.t).abs().max().item()
    if e_pose > 2e-3 or e_v > 2e-2 or not moved > 0:
        raise AssertionError(f"local_inertial_ba: card and CPU differ: poses {e_pose}, velocities {e_v}")
    log(f"reference: inertial stages, card vs CPU: preintegrate/compose within 1e-5 (cov {cov_err:.1e} relative), "
        f"solve_pose_inertial pose diff {max(errs['R_wb'], errs['p_w']):.2e}, velocity {errs['v_w']:.2e}, "
        f"{int(n_c)} / {int(n_g)} inliers; local_inertial_ba over {int(imu_mask.sum())} factors: poses {e_pose:.2e}, "
        f"velocities {e_v:.2e} (BA moved the window by up to {moved:.3f} m)")


def phase_main_path(dev, smi):
    import numpy as np
    import torch

    from pli_slam_tpu_torch.frontend.tracker import Tracker
    from pli_slam_tpu_torch.ops.kernels import hamming
    from pli_slam_tpu_torch.utils import synthetic
    from pli_slam_tpu_torch.utils.profile import N_FRAMES, N_WARM, slice_camera, slice_config

    cfg = slice_config()
    cam = slice_camera()
    t0 = time.perf_counter()
    frames = list(synthetic.make_sequence(cam, N_FRAMES, dev, fps=cfg.fps))
    torch.cuda.synchronize()
    digest = synthetic.frame_digest(frames[0]["img_l"], frames[0]["img_r"])
    log(f"main path: rendered {N_FRAMES} frames {cam.width}x{cam.height} on the host in {time.perf_counter() - t0:.2f} "
        f"s; first pair's SHA-256 {digest} (a CPU build computes {FRAME0_SHA256}: "
        f"{'equal' if digest == FRAME0_SHA256 else 'DIFFERENT'})")
    if digest != FRAME0_SHA256:
        raise AssertionError("the frames differ from the CPU's (tests/test_torch_datasets.py holds the digest)")

    tracker = Tracker(cam, cfg, dev)
    tracker.streaming = True
    reset_counts()
    times = []
    t_start = None
    for i, fr in enumerate(frames):
        if i == N_WARM:
            torch.cuda.synchronize()
            t_start = time.perf_counter()
        f0 = time.perf_counter()
        tracker.process(fr["img_l"], fr["img_r"], fr["t"])
        if i >= N_WARM:
            times.append(time.perf_counter() - f0)
    tracker.finalize()
    est = tracker.positions()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t_start
    launches = hamming.launches
    count_small_kernels()

    fps = (N_FRAMES - N_WARM) / elapsed
    ms = np.asarray(times) * 1e3
    gt = np.stack([fr["p_w"] for fr in frames])
    if est.shape != gt.shape or not np.all(np.isfinite(est)):
        raise AssertionError(f"trajectory shape {est.shape} / finite {np.all(np.isfinite(est))}")
    ate = synthetic.ate_rmse(est, gt)
    ok_frames = _consumed_ok(tracker)
    n_fused = N_FRAMES - 1
    n_kf = tracker.n_kf
    log(f"main path: fps {fps:.3f}, p50 {np.percentile(ms, 50):.2f} ms, p99 {np.percentile(ms, 99):.2f} ms, "
        f"ATE {ate:.4f} m, n_kf {n_kf}, ok frames {ok_frames}/{N_FRAMES}, gated_match launches {launches} "
        f"over {n_fused} fused frames [{smi}]")
    if ok_frames < 0.9 * N_FRAMES:
        raise AssertionError(f"only {ok_frames}/{N_FRAMES} frames tracked")
    if n_kf < 3:
        raise AssertionError(f"only {n_kf} keyframes")
    if not ate < 0.10:
        raise AssertionError(f"ATE {ate} m >= 0.10 m (divergence guard)")
    if launches < 2 * n_fused:
        raise AssertionError(f"gated_match launched {launches} times for {n_fused} fused frames")
    n_rot3 = ROT3_LAUNCHES["phase_main_path"]
    log(f"main path: closest_rotation launches {n_rot3} ({n_rot3 / n_fused:.1f} per fused frame); fused step "
        f"captured in {tracker._step.capture_ms:.1f} ms, graph pool {tracker._step.pool_bytes / 2**20:.1f} MiB, "
        f"{tracker._step.replays} graph replays; {warmups(tracker)} [{smi}]")
    if n_rot3 < n_fused or tracker._step.replays < n_fused:
        raise AssertionError(f"closest_rotation launched {n_rot3} times and the graphs replayed "
                             f"{tracker._step.replays} times for {n_fused} fused frames")
    return launches, N_FRAMES, frames


def phase_vi_path(dev, smi):
    """Phase 5: the stereo-inertial path at full width (see the module docstring)."""
    import numpy as np
    import torch

    from pli_slam_tpu_torch.frontend.tracker import Tracker, TrackingState
    from pli_slam_tpu_torch.ops.kernels import hamming
    from pli_slam_tpu_torch.utils import synthetic
    from pli_slam_tpu_torch.utils.profile import (N_FRAMES_VI, slice_camera, slice_config_vi, stage_captures,
                                                  vi_frames)

    cfg, cam = slice_config_vi(), slice_camera()
    t0 = time.perf_counter()
    frames = vi_frames(cam, cfg, N_FRAMES_VI, dev)
    torch.cuda.synchronize()
    log(f"vi path: rendered {N_FRAMES_VI} frames {cam.width}x{cam.height} with {len(frames[0]['imu_gyro'])} IMU "
        f"samples each in {time.perf_counter() - t0:.2f} s")

    tracker = Tracker(cam, cfg, dev)
    tracker.streaming = True
    held, replays, traced = {}, [], []
    hold_calls(tracker, {"_try_imu_init": (lambda tr: True, lambda tr, ret: tr.imu_ready)}, held)
    reset_counts()
    ms_host, ms_fused, launches_host = [], [], None
    init_frame = init_ms = None
    for i, fr in enumerate(frames):
        fused = tracker.imu_ready and tracker.gravity_w is not None and tracker.state == TrackingState.OK
        if fused and launches_host is None:
            launches_host = hamming.launches
            count_small_kernels()
        with check_replays(INIT_STAGES, replays):
            if imu_init_due(tracker, fr["t"]):  # the frame that may initialize the IMU: its host launches
                wall, _, n, ng = _traced(dev, lambda: tracker.process(fr["img_l"], fr["img_r"], fr["t"],
                                                                      imu=fr["imu"]))
                traced.append((i, n, ng, wall * 1e3))
                dt_ms = wall * 1e3
            else:
                f0 = time.perf_counter()
                tracker.process(fr["img_l"], fr["img_r"], fr["t"], imu=fr["imu"])
                dt_ms = (time.perf_counter() - f0) * 1e3
        if tracker.imu_ready and init_frame is None:
            init_frame, init_ms = i, dt_ms  # this frame ran the initialization: kept out of the percentiles
            v_err = float(np.linalg.norm(tracker.v_w.cpu().numpy() - fr["v_w"]))
            # the trajectory so far, read without consuming it (later BA still refines these frames)
            pend, done = list(tracker._traj_pending), list(tracker._traj_done)
            ate_init = synthetic.ate_rmse(tracker.positions(), np.stack([f["p_w"] for f in frames[:i + 1]]))
            tracker._traj_pending, tracker._traj_done = pend, done
        elif i > 0:
            (ms_fused if fused else ms_host).append(dt_ms)
    tracker.finalize()
    est = tracker.positions()
    torch.cuda.synchronize()
    launches = hamming.launches
    count_small_kernels()

    if not tracker.imu_ready or init_frame is None:
        raise AssertionError(f"IMU initialization never fired: {tracker.imu_init_log[-3:]}")
    rec = tracker.imu_init_log[-1]
    if not rec["accepted"]:
        raise AssertionError(f"IMU initialization not accepted: {rec}")
    R0, _ = synthetic.Trajectory().pose(0.0)
    g_true = R0.T @ np.array([0.0, 0.0, -9.81])
    g = tracker.gravity_w.cpu().numpy().astype(np.float64)
    g_angle = float(np.degrees(np.arccos(np.clip(g @ g_true / np.linalg.norm(g) / 9.81, -1.0, 1.0))))
    g_mag = float(np.linalg.norm(g))
    gt = np.stack([fr["p_w"] for fr in frames])
    if est.shape != gt.shape or not np.all(np.isfinite(est)):
        raise AssertionError(f"trajectory shape {est.shape} / finite {np.all(np.isfinite(est))}")
    ate = synthetic.ate_rmse(est, gt)
    # host-path frames report at once, the fused ones one frame late
    n_host = init_frame + 1
    n_fused = N_FRAMES_VI - n_host
    ok_frames = _consumed_ok(tracker, n_host)
    kf_at_init = rec["n_kf"]
    n_kf = tracker.n_kf
    vi_kfs = n_kf - kf_at_init  # keyframes made by the fused step, each with VI-BA (n_kf >= 3 since before init)
    launches_fused = launches - launches_host
    pct = lambda v, q: float(np.percentile(v, q))  # noqa: E731
    log(f"vi path: IMU init at frame {init_frame} ({rec['n_kf']} keyframes), that frame {init_ms:.1f} ms, the "
        f"initialization {rec['wall_ms']:.1f} ms of it; gravity {g_angle:.2f} deg from the truth, |g| {g_mag:.3f}; "
        f"velocity {v_err:.3f} m/s from the truth, ATE of frames 0-{init_frame} {ate_init:.4f} m; "
        f"bg {np.round(rec['bg'], 4).tolist()}, ba {np.round(rec['ba'], 4).tolist()} [{smi}]")
    log(f"vi path: host-path frames 1-{init_frame - 1}: fps {1e3 / np.mean(ms_host):.3f}, p50 {pct(ms_host, 50):.2f} ms, "
        f"p99 {pct(ms_host, 99):.2f} ms, gated_match launches {launches_host} ({launches_host / (n_host - 1):.2f} per "
        f"tracked frame) [{smi}]")
    log(f"vi path: fused stereo-inertial frames {n_host}-{N_FRAMES_VI - 1}: fps {1e3 / np.mean(ms_fused):.3f}, "
        f"p50 {pct(ms_fused, 50):.2f} ms, p99 {pct(ms_fused, 99):.2f} ms, gated_match launches {launches_fused} "
        f"({launches_fused / n_fused:.2f} per frame), {vi_kfs} keyframes with VI-BA [{smi}]")
    log(f"vi path: ATE {ate:.4f} m, n_kf {n_kf}, ok frames {ok_frames}/{N_FRAMES_VI}, gated_match launches {launches} "
        f"over {N_FRAMES_VI - 1} tracked frames [{smi}]")
    if g_angle > 8.0 or abs(g_mag - 9.81) > 0.15 * 9.81:
        raise AssertionError(f"gravity {g} is {g_angle:.2f} deg / {g_mag:.3f} m/s^2 against {g_true}")
    if v_err > 0.8 or not ate_init < 0.10:
        raise AssertionError(f"at the IMU initialization: velocity {v_err} m/s from the truth, ATE {ate_init} m")
    if n_fused < 20:
        raise AssertionError(f"only {n_fused} frames ran the fused stereo-inertial step")
    if vi_kfs < 1:
        raise AssertionError("no fused stereo-inertial frame took the keyframe branch")
    if ok_frames < 0.9 * N_FRAMES_VI:
        raise AssertionError(f"only {ok_frames}/{N_FRAMES_VI} frames tracked")
    if not ate < 2.0:
        raise AssertionError(f"ATE {ate} m >= 2.0 m (beyond what visual-inertial BA's drift does to either package)")
    if launches < 2 * (N_FRAMES_VI - 1) or launches_host < 2 * (n_host - 1) or launches_fused < 2 * n_fused:
        raise AssertionError(f"gated_match launched {launches_host} + {launches_fused} times for {n_host - 1} host-path "
                             f"and {n_fused} fused frames")
    n_rot3, vi_step = ROT3_LAUNCHES["phase_vi_path"], tracker._step_vi
    log(f"vi path: closest_rotation launches {n_rot3}; fused stereo-inertial step captured in "
        f"{vi_step.capture_ms:.1f} ms, graph pool {vi_step.pool_bytes / 2**20:.1f} MiB, {vi_step.replays} graph "
        f"replays; host-path stages captured in (ms) {stage_captures(tracker)}, graph pool "
        f"{sum(p.pool_bytes for p in tracker.stage_programs()) / 2**20:.1f} MiB, "
        f"{sum(p.replays for p in tracker.stage_programs())} stage replays; {warmups(tracker)} [{smi}]")
    if n_rot3 < N_FRAMES_VI - 1 or vi_step.replays < 0.9 * n_fused:
        raise AssertionError(f"closest_rotation launched {n_rot3} times and the graphs replayed {vi_step.replays} "
                             f"times for {n_fused} fused frames")
    init_paths("vi path", dev, tracker, held, replays, traced, init_frame, smi)
    return launches, N_FRAMES_VI, (cfg, frames)


# ---------------------------------------------------------------------------
# Phase 6: loop closing, relocalization and the Atlas at full width
# ---------------------------------------------------------------------------


def _world_pose(traj, t, R_wc, p_w):
    """A room-frame camera pose (R_wc, p_w) in the tracker's world (the first
    camera's frame, at trajectory time `t`) as T_cw = (R_cw, t_cw)."""
    import numpy as np

    R0, p0 = traj.pose(t)
    R_cw = (R0.T @ R_wc).T
    return R_cw, -R_cw @ (R0.T @ (np.asarray(p_w) - p0))


def _consumed_ok(tracker, n_host: int = 1):
    """Frames reported OK in streaming mode after `n_host` host-path frames:
    the first fused frame only appends a placeholder, and the last frame's
    stats are still pending."""
    from pli_slam_tpu_torch.frontend.step import ST_OK
    from pli_slam_tpu_torch.frontend.tracker import TrackingState

    consumed = tracker.stats[:n_host] + tracker.stats[n_host + 1:]
    pending = tracker._pending_stats
    return (sum(1 for s in consumed if s["state"] == TrackingState.OK)
            + int(pending is not None and float(pending[1].read()[ST_OK]) > 0))


RARE_TENSORS = ("kstore", "pstore", "lstore", "bow_db", "_local_pt", "R", "t", "has_vel", "gravity_w")
RARE_HOST = ("n_kf", "state", "imu_ready", "_map_event_cooldown")
RARE_CLOSER = ("n_loops_closed", "_last_closed_kf", "_consistency", "_consistent_with")


def _rare_state(tracker, closer=None) -> dict:
    """What a rare path reads and writes on `tracker` (and its loop closer):
    the stores, the BoW database, the local map, the live pose, as copies
    (under graphs they are buffers the next replay overwrites); the host's
    counters, the queued BA chunks, the records' count (the relocalization's
    draw seed)."""
    from pli_slam_tpu_torch.frontend import graphs

    out = {name: graphs.tree_clone(getattr(tracker, name)) for name in RARE_TENSORS}
    out.update({name: getattr(tracker, name) for name in RARE_HOST})
    out["deferred"] = [(kind, repr(arg)) for kind, arg in tracker._deferred_ba]
    out["n_stats"] = len(tracker.stats)
    if closer is not None:
        out.update({name: getattr(closer, name) for name in RARE_CLOSER})
    return out


def _rare_install(tracker, state: dict, closer=None) -> None:
    """Put a `_rare_state` into a tracker of the same configuration (the
    queued chunks are dropped: both runs start from an empty queue)."""
    for name in RARE_TENSORS + RARE_HOST:
        setattr(tracker, name, state[name])
    tracker._deferred_ba = []
    tracker.stats = [{} for _ in range(state["n_stats"])]
    if closer is not None:
        for name in RARE_CLOSER:
            setattr(closer, name, state[name])


def _rare_difference(g: dict, e: dict) -> str | None:
    """The first entry (a tensor field, or a host value) where two `_rare_state`s differ in any bit, or None."""
    from pli_slam_tpu_torch.frontend import graphs

    for name in g:
        if name in RARE_TENSORS:
            for i, (a, b) in enumerate(zip(graphs.tree_leaves(g[name]), graphs.tree_leaves(e[name]), strict=True)):
                if not _bits_equal(a, b):
                    return f"{name} (leaf {i})"
        elif g[name] != e[name]:
            return f"{name} ({g[name]!r} / {e[name]!r})"
    return None


def _rare_eager(dev, cam, cfg, held: dict, call) -> dict:
    """The call a graph tracker made (`held`: the state before it and what it
    did), made again from that state by a `cuda_graphs=False` tracker: `call
    (tracker)` under a CUDA-activity trace. Fails on the first bit that
    differs (the state after, the result, every kernel's launches). Returns
    the eager side's numbers; the eager launches are not the phase's."""
    from pli_slam_tpu_torch.frontend.tracker import Tracker

    te = Tracker(cam, cfg, dev, cuda_graphs=False)
    closer = te.loop_closer if "n_loops_closed" in held["before"] else None
    _rare_install(te, held["before"], closer)
    out, k0 = [], kernel_counts()
    wall, _, launches, graph_launches = _traced(dev, lambda: out.append(call(te)))
    kernels = tuple(b - a for a, b in zip(k0, kernel_counts()))
    g = held["graphs"]
    diff = _rare_difference(g["after"], _rare_state(te, closer))
    if diff is None and out[0] != g["ret"]:
        diff = f"the result ({g['ret']} / {out[0]})"
    if diff is None and kernels != g["kernels"]:
        diff = f"the kernels' launches (gated_match, closest_rotation, largest_eigvec, svd_small) {g['kernels']} / " \
               f"{kernels}"
    if diff is not None:
        raise AssertionError(f"{held['what']}: graphs and eager differ first at {diff}")
    reset_counts()
    return dict(ret=out[0], wall=wall, launches=launches, graph_launches=graph_launches, kernels=kernels)


def _rare_line(held: dict, eager: dict) -> str:
    g = held["graphs"]
    return (f"{held['what']}: with graphs {1e3 * g['wall']:.1f} ms, {g['launches']} kernel and {g['graph_launches']} "
            f"graph launches from the host; eager from the same state {1e3 * eager['wall']:.1f} ms, "
            f"{eager['launches']} kernel and {eager['graph_launches']} graph launches; bit-identical (the state after, "
            f"the result {g['ret']}, the kernels' launches {g['kernels']})")


# The map initializations' and the merge's stages (PR 15): every call under graphs checked against the stage run
# eagerly on its inputs, and the paths they serve made again from the same state by a `cuda_graphs=False` tracker.
INIT_STAGES = ("mono_init_match", "mono_init", "track_init", "mono_depths", "imu_init", "merge_query", "merge_match",
               "merge_verify", "rebuild_bow")
# what a tracker carries besides its state: programs, configuration, its closer and Atlas (held apart), records
HELD_SKIP = {"_stages", "_step", "_step_vi", "_fused_last", "_images", "_imu_upload", "_counters_ahead",
             "fused_warmup_ms", "_build_stage", "_stage_pool", "build_frame", "cfg", "cam", "cam_raw",
             "rectifier", "voc_pt", "voc_ln", "draw", "span", "loop_closer", "atlas", "device", "cuda_graphs",
             "stats", "imu_init_log", "_counts", "loop_warmup_ms", "reloc_warmup_ms", "merge_warmup_ms",
             "init_warmup_ms", "_warmed", "is_mono", "is_rgbd", "use_imu", "streaming", "_imu_pad"}


def _deep_clone(x):
    """`x` with every tensor and array copied (dicts, lists, tuples, dataclasses walked)."""
    import numpy as np
    import torch

    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, np.ndarray):
        return x.copy()
    if isinstance(x, dict):
        return {k: _deep_clone(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_deep_clone(v) for v in x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{f.name: _deep_clone(getattr(x, f.name)) for f in dataclasses.fields(x)})
    return x


def _held_state(tracker) -> dict:
    """Everything a host path of `tracker` reads and writes, copied: its own
    attributes but HELD_SKIP's and functions (`hold_calls`' wrappers), the
    Atlas's maps, the loop closer's counters."""
    tracker._sync_counters()  # the counter mirrors current (after a streaming fused frame the device's lead)
    out = {k: _deep_clone(v) for k, v in vars(tracker).items() if k not in HELD_SKIP and not callable(v)}
    out["atlas"] = (_deep_clone(tracker.atlas.maps), tracker.atlas.active_idx)
    if tracker.loop_closer is not None:
        out["closer"] = {name: getattr(tracker.loop_closer, name) for name in RARE_CLOSER}
    return out


def _held_install(tracker, state: dict) -> None:
    """Put a `_held_state` (copied again) into a tracker of the same configuration."""
    state = _deep_clone(state)
    for k, v in state.items():
        if k == "atlas":
            tracker.atlas.maps, tracker.atlas.active_idx = v
        elif k == "closer":
            for name, val in v.items():
                setattr(tracker.loop_closer, name, val)
        else:
            setattr(tracker, k, v)
    tracker._counts = None
    tracker._counters_moved = True  # the mirrors just set are the tracker's counters


def _held_difference(a, b, where: str = "") -> str | None:
    """The first leaf (a tensor or an array in any bit, or another value) where two trees differ, or None."""
    import numpy as np
    import torch

    if isinstance(a, torch.Tensor):
        return None if isinstance(b, torch.Tensor) and _bits_equal(a, b) else where
    if isinstance(a, np.ndarray):
        return None if np.array_equal(a.view(np.uint8), np.asarray(b).view(np.uint8)) else where
    if isinstance(a, dict):
        if a.keys() != b.keys():
            return where
        return next((d for k in a for d in [_held_difference(a[k], b[k], f"{where}.{k}")] if d), None)
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            return where
        return next((d for i, (x, y) in enumerate(zip(a, b)) for d in [_held_difference(x, y, f"{where}[{i}]")] if d),
                    None)
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        return next((d for f in dataclasses.fields(a) for d in [_held_difference(getattr(a, f.name),
                                                                                 getattr(b, f.name),
                                                                                 f"{where}.{f.name}")] if d), None)
    return None if a == b else f"{where} ({a!r} / {b!r})"


def hold_calls(tracker, holds: dict, held: dict) -> None:
    """Wrap tracker methods: `holds` maps a method's name to (before, after),
    two predicates on the tracker (after also gets the result). The first
    call for which both hold is kept in `held[name]`: the state before it,
    its arguments, result, wall time (the device synchronised), the kernels'
    launches and the state after it."""
    import torch

    for name, (before, after) in holds.items():
        orig = getattr(tracker, name)

        def call(*args, _name=name, _orig=orig, _before=before, _after=after):
            if _name in held or not _before(tracker):
                return _orig(*args)
            state, kept = _held_state(tracker), _deep_clone(args)
            k0, t0 = kernel_counts(), time.perf_counter()
            ret = _orig(*args)
            if tracker.device.type == "cuda":
                torch.cuda.synchronize(tracker.device)
            wall = time.perf_counter() - t0
            if _after(tracker, ret):
                held[_name] = dict(before=state, args=kept, ret=ret, wall=wall, after=_held_state(tracker),
                                   kernels=tuple(b - a for a, b in zip(k0, kernel_counts())))
            return ret

        setattr(tracker, name, call)


def held_eager(dev, tracker, name: str, h: dict) -> dict:
    """The call `h` (from `hold_calls`) made again from its state before by a
    `cuda_graphs=False` tracker of `tracker`'s configuration, the device
    synchronised at both ends (untraced: an eager path's trace takes
    seconds to export). Fails on the first bit that differs (the state
    after, the result, every kernel's launches). Returns its wall time."""
    import torch

    from pli_slam_tpu_torch.frontend.tracker import Tracker

    te = Tracker(tracker.cam_raw, tracker.cfg, dev, cuda_graphs=False)
    _held_install(te, h["before"])
    args, k0 = _deep_clone(h["args"]), kernel_counts()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = [getattr(te, name)(*args)]
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    kernels = tuple(b - a for a, b in zip(k0, kernel_counts()))
    diff = _held_difference(h["after"], _held_state(te), "tracker")
    if diff is None and out[0] != h["ret"]:
        diff = f"the result ({h['ret']} / {out[0]})"
    if diff is None and kernels != h["kernels"]:
        diff = f"the kernels' launches (gated_match, closest_rotation, largest_eigvec, svd_small) {h['kernels']} / " \
               f"{kernels}"
    if diff is not None:
        raise AssertionError(f"{name}: graphs and eager differ first at {diff}")
    reset_counts()
    return dict(wall=wall)


def init_stage_report(label: str, tracker, replays: list) -> str:
    """Check `replays` (from check_replays over INIT_STAGES: each call under
    graphs bit for bit the stage run eagerly) and describe the new stages'
    captures: count, ms and graph pool, and the tracker's warm-ups."""
    bad = [(name, leaf) for name, leaf, _ in replays if leaf is not None]
    if tracker.cuda_graphs and bad:
        raise AssertionError(f"{label}: a stage's graph differs from the stage run eagerly (stage, first output leaf): "
                             f"{bad}")
    counts = {}
    for name, _, _ in replays:
        counts[name] = counts.get(name, 0) + 1
    caps = {p.name: (p.captures, round(p.capture_ms, 1), round(p.pool_bytes / 2**20, 1))
            for p in tracker.stage_programs() if p.name in INIT_STAGES and p.captures}
    warm = {k: None if getattr(tracker, k) is None else round(getattr(tracker, k), 1)
            for k in ("init_warmup_ms", "merge_warmup_ms")}
    return (f"{label}: the new stages' calls under graphs, each bit for bit the stage run eagerly on its inputs: "
            f"{counts}; their captures (count, ms, graph pool MiB) {caps}; warm-ups (ms) {warm}")


def held_line(label: str, h: dict, eager: dict, frame: tuple | None) -> str:
    """One held path: its wall time with graphs and eagerly from the same state, and the graph frame's launches."""
    fr = "" if frame is None else (f"; the whole frame under graphs (traced) {frame[2]:.1f} ms, {frame[0]} kernel and "
                                   f"{frame[1]} graph launches from the host")
    return (f"{label}: with graphs {1e3 * h['wall']:.1f} ms; eager from the same state {1e3 * eager['wall']:.1f} ms; "
            f"bit-identical (the state after, the result, the kernels' launches {h['kernels']}){fr}")


def imu_init_due(tracker, stamp: float) -> bool:
    """Whether the next frame (at `stamp`) may run the IMU initialization (traced then)."""
    cfg = tracker.cfg.imu
    return (not tracker.imu_ready and tracker._first_imu_stamp is not None and tracker.n_kf >= cfg.init_min_kfs
            and stamp - tracker._first_imu_stamp >= cfg.init_time_sec)


def init_paths(label, dev, tracker, held, replays, traced, init_frame, smi, limited=True) -> None:
    """After a phase that initialized the IMU (or a mono map, or merged:
    `held` from `hold_calls`): each held path made again eagerly from its
    state before (`held_eager`) and printed beside its graph side; the new
    stages' checks and captures (`init_stage_report`); the initialization
    frame's host launches (`traced` (frame, kernel launches, graph
    launches, ms) of the frames that may have run it) under
    HOST_LAUNCH_LIMIT unless not `limited`."""
    frame = next((f for f in traced if f[0] == init_frame), None)
    t0 = time.perf_counter()
    for name, h in held.items():
        eager = held_eager(dev, tracker, name, h)
        log(held_line(f"{label}: {name} (the frame {init_frame if name != '_create_keyframe' else 'of a keyframe'})", h,
                      eager, frame[1:] if frame is not None and name != "_create_keyframe" else None) + f" [{smi}]")
    log(init_stage_report(label, tracker, replays) + f"; the eager reruns took {time.perf_counter() - t0:.1f} s and "
        f"the stages' checks {sum(sec for _, _, sec in replays):.1f} s of the phase [{smi}]")
    if tracker.cuda_graphs and limited:
        if frame is None:
            raise AssertionError(f"{label}: the initialization frame {init_frame} was not traced ({traced})")
        launch_limited(f"{label}: the initialization frame", [frame])


def launch_limited(label: str, frames: list) -> None:
    """Fail if a traced frame (index, kernel launches, graph launches, ms) issued more than HOST_LAUNCH_LIMIT."""
    worst = max(frames, key=lambda f: f[1])
    if worst[1] > HOST_LAUNCH_LIMIT:
        raise AssertionError(f"{label}: frame {worst[0]} under graphs issued {worst[1]} kernel launches (limit "
                             f"{HOST_LAUNCH_LIMIT}): a stage ran eagerly ({frames})")


def phase_loop(dev, smi):
    """6a (see the module docstring): the loop-closing run. Returns its
    launches, frame count and what 6b continues from. Its one-ulp run
    (`pre_closure_run`) builds a second loop-closing tracker under graphs
    while the first is alive; since ROADMAP queue 3 A8's repair any number
    of them may follow in one process (phase 16 builds five)."""
    import numpy as np
    import torch

    from pli_slam_tpu_torch.ops.kernels import hamming
    from pli_slam_tpu_torch.utils.profile import N_FRAMES_LOOP, loop_frames, loop_run, pre_closure_run

    from pli_slam_tpu_torch.frontend.loop_closing import LoopCloser

    t0 = time.perf_counter()
    cfg, cam, traj, frames = loop_frames(dev)
    torch.cuda.synchronize()
    log(f"loop: rendered {len(frames)} frames of bench.py's flagship trajectory in {time.perf_counter() - t0:.2f} s")
    held, orig = {"what": "loop 6a, the closure's verification and correction"}, LoopCloser._verify_and_close

    def verify_and_close(closer, tracker, kf_slot, candidates):
        """The first verification under graphs: the state before, then the call traced."""
        if "graphs" in held or not tracker.cuda_graphs:
            return orig(closer, tracker, kf_slot, candidates)
        held["before"], held["args"] = _rare_state(tracker, closer), (kf_slot, list(candidates))
        out, k0 = [], kernel_counts()
        wall, _, n, ng = _traced(dev, lambda: out.append(orig(closer, tracker, kf_slot, candidates)))
        held["graphs"] = dict(ret=out[0], wall=wall, launches=n, graph_launches=ng,
                              kernels=tuple(b - a for a, b in zip(k0, kernel_counts())),
                              after=_rare_state(tracker, closer))
        return out[0]

    reset_counts()
    LoopCloser._verify_and_close = verify_and_close
    try:
        with record_rare_args():
            r = loop_run(cfg, cam, traj, frames, dev)
    finally:
        LoopCloser._verify_and_close = orig
    launches = hamming.launches
    count_small_kernels()
    if "graphs" not in held:
        raise AssertionError("loop 6a: no verification ran under graphs")
    eager = _rare_eager(dev, cam, cfg, held,
                        lambda te: LoopCloser._verify_and_close(te.loop_closer, te, *held["args"]))
    log(_rare_line(held, eager) + f" [{smi}]")
    if held["graphs"]["kernels"][2] < 1:
        raise AssertionError(f"loop 6a: the verification launched largest_eigvec {held['graphs']['kernels'][2]} times")
    if held["graphs"]["launches"] > HOST_LAUNCH_LIMIT or not held["graphs"]["graph_launches"]:
        raise AssertionError(f"loop 6a: the closure under graphs issued {held['graphs']['launches']} kernel and "
                             f"{held['graphs']['graph_launches']} graph launches (limit {HOST_LAUNCH_LIMIT}): a stage "
                             f"ran eagerly")
    tracker, lc, t_gba = r["tracker"], r["tracker"].loop_closer, r["t_gba"]
    n_frames = len(frames)
    ok_frames = _consumed_ok(tracker)
    est = r["est"]
    ate = r["ate"]
    ms = np.asarray(r["ms_plain"])
    pct = lambda q: float(np.percentile(ms, q))  # noqa: E731
    gba_ms = [round(t, 2) for t in t_gba]
    kf_err_ms = [round(e, 4) for e in r["kf_errs"]]
    log(f"loop: Tracker construction ran the closure's warm-up in {tracker.loop_warmup_ms:.2f} ms; {warmups(tracker)} "
        f"[{smi}]")
    log(f"loop: {N_FRAMES_LOOP} frames, ordinary frames: fps {N_FRAMES_LOOP / r['wall']:.3f} over the run, mean "
        f"{ms.mean():.2f} ms, p50 {pct(50):.2f} ms, p99 {pct(99):.2f} ms; {r['n_kf_run']} keyframes, ATE "
        f"{r['ate_run']:.4f} m, loops closed by the run {r['natural']} (frames with a verification: frame, ms, closed, "
        f"imu_ready {r['loop_frames']}) [{smi}]")
    planted = r["planted"]
    if planted is not None:
        log(f"loop: no candidate reached the closer; planted closure keyframe {planted['kf_cur']} -> "
            f"{planted['kf_loop']} (ground-truth pose distance {planted['cost']:.3f}), verified {planted['closed']}, "
            f"verification + PGO + queueing {planted['ms']:.2f} ms with the CUDA-activity trace of the call (the line "
            f"above: the call alone) (the correction alone once more, eagerly, warm: "
            f"{planted['warm_ms']:.2f} ms); largest keyframe position error against the truth "
            f"{planted['kf_before']:.4f} m before, {planted['kf_after']:.4f} m after the correction [{smi}]")
    log(f"loop: {r['n_queued']} GBA chunks queued, {len(t_gba)} run, ms each {gba_ms}, largest keyframe position "
        f"error after each {kf_err_ms} m; queue left {len(tracker._deferred_ba)}; "
        f"ATE {ate:.4f} m over {n_frames} frames, ok frames {ok_frames}/{n_frames}, gated_match launches {launches} "
        f"({launches / (n_frames - 1):.2f} per fused frame) [{smi}]")
    if lc.n_loops_closed < 1:
        raise AssertionError("no loop closed")
    if tracker._deferred_ba or not t_gba or r["n_queued"] < 1:
        raise AssertionError(f"GBA chunks: {r['n_queued']} queued, {len(t_gba)} run, {len(tracker._deferred_ba)} left")
    if ok_frames < 0.9 * n_frames:
        raise AssertionError(f"only {ok_frames}/{n_frames} frames tracked")
    # the reference on its own run of these frames: 0.0276 m before the closure and 0.1290 m after it and its
    # GBA chunks, whose first throws keyframes ~1 m off in both packages; the port's runs: PERF.md, section 6
    if not (r["ate_run"] < 0.10 and np.all(np.isfinite(est)) and ate < 0.35):
        raise AssertionError(f"ATE {r['ate_run']} m before the closure, {ate} m after it")
    # the same frames up to the closure once more, the pose one float32 ulp off after frame 1: a rounding
    # difference must not move the map by centimetres (ROADMAP queue 3 A6)
    t1 = time.perf_counter()
    nudged = pre_closure_run(cfg, cam, traj, frames, dev, nudge_after=1)
    log(f"loop: the frames up to the closure again, the pose one ulp toward zero after frame 1: ATE "
        f"{nudged['ate']:.4f} m ({r['ate_run']:.4f} m unperturbed), {nudged['n_kf']} keyframes ({r['n_kf_run']}), "
        f"largest position difference {np.abs(nudged['est'] - r['est_run']).max():.4e} m, "
        f"{time.perf_counter() - t1:.1f} s [{smi}]")
    if np.array_equal(nudged["est"], r["est_run"]):
        raise AssertionError("loop 6a: the one-ulp nudge left the run bit-identical: it nudged nothing")
    if not (r["ate_run"] < ROUNDING_ATE_BOUND and nudged["ate"] < ROUNDING_ATE_BOUND):
        raise AssertionError(f"loop 6a: ATE before the closure {r['ate_run']} m, {nudged['ate']} m one ulp away "
                             f"(bound {ROUNDING_ATE_BOUND} m)")
    if launches < 2 * (n_frames - 1):
        raise AssertionError(f"gated_match launched {launches} times for {n_frames - 1} fused frames")
    return launches, n_frames, (tracker, traj, frames)


def _kidnap(dev, tracker, traj):
    """tests/test_reloc_pnp.py's kidnap at full width: the pose at t = 0.1
    moved by (0.45, 0.3, -0.25) m and turned 0.35 rad in yaw. Returns its
    stereo pair and the position of the re-track seeded with the true pose
    (in `tracker`'s world, on its map), with that re-track's inlier count."""
    import numpy as np
    import torch

    from pli_slam_tpu_torch.frontend import step as step_mod
    from pli_slam_tpu_torch.utils import synthetic

    cam = tracker.cam
    R_wc, p_w = traj.pose(0.1)
    p_kid = p_w + np.array([0.45, 0.3, -0.25])
    yaw = 0.35
    R_wc = R_wc @ np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0], [-np.sin(yaw), 0, np.cos(yaw)]])
    R_d = torch.as_tensor(R_wc, dtype=torch.float32, device=dev)
    p_d = torch.as_tensor(p_kid, dtype=torch.float32, device=dev)
    img_l = synthetic.render_view(cam, R_d, p_d)
    img_r = synthetic.render_view(cam, R_d, p_d + R_d[:, 0] * cam.baseline)
    R_cw, t_cw = _world_pose(traj, 0.0, R_wc, p_kid)
    R_ref, t_ref, *_, n_ref, _, _ = step_mod.track_step(
        cam, tracker.cfg, tracker.build_frame(img_l, img_r), torch.as_tensor(R_cw, dtype=torch.float32, device=dev),
        torch.as_tensor(t_cw, dtype=torch.float32, device=dev), tracker.pstore, tracker.lstore,
        torch.zeros((), dtype=torch.bool, device=dev))
    return img_l, img_r, -(R_ref.T @ t_ref).cpu().numpy(), int(n_ref)


def _feed_kidnap(tracker, img_l, img_r, t_last, p_ref, traced=None):
    """Feed the kidnap view up to 6 times (streaming) to `tracker`, whose
    `span` is a SyncSpans. Returns (the frame at which a relocalization has
    been accepted and the pose is OK within 0.2 m of `p_ref`, or None; the
    last error in m; states; reported inliers; (ms, accepted) of each
    relocalization attempt: accepted if its frame reports OK). With `traced`
    (a list) each frame runs in a CUDA-activity trace, and each frame that
    attempted a relocalization appends (its host kernel launches, graph
    launches, wall ms)."""
    import numpy as np

    from pli_slam_tpu_torch.frontend.tracker import TrackingState

    reloc_ms = tracker.span.ms["reloc"]
    recovered, err, states, inliers, attempts = None, np.inf, [], [], []
    for i in range(6):
        n0 = len(reloc_ms)
        stamp = t_last + 0.05 * (i + 1)
        if traced is None:
            info = tracker.process(img_l, img_r, stamp)
        else:
            res = []
            wall, _, n, ng = _traced(tracker.device, lambda: res.append(tracker.process(img_l, img_r, stamp)))
            info = res[0]
            if len(reloc_ms) > n0:
                traced.append((n, ng, round(1e3 * wall, 1)))
        ok = info["state"] == TrackingState.OK
        states.append(info["state"])
        inliers.append(info["n_inliers"])
        attempts += [(round(t, 2), ok) for t in reloc_ms[n0:]]
        err = float(np.linalg.norm(-(tracker.R.T @ tracker.t).cpu().numpy() - p_ref))
        if any(a for _, a in attempts) and ok and err < 0.2:
            recovered = i
            break
    return recovered, err, states, inliers, attempts


def phase_kidnap(dev, smi, run):
    """6b (see the module docstring): the kidnap, first fed to phase 6a's
    tracker (reported), then to a tracker with raised inlier floors over the
    trajectory's first 20 frames (guarded). tests/test_reloc_pnp.py raises
    its floors for the same reason (20 / 25 at 128x96); at this width a
    wrong pose reached 24-32 inliers against a true re-track's 574-710
    (PERF.md, section 6, loop closing), so the floors are 60 / 60. The
    re-tracks seeded with the true pose are the script's own and run outside
    the launch counts."""
    import dataclasses as dc

    import torch

    from pli_slam_tpu_torch.frontend import graphs
    from pli_slam_tpu_torch.frontend.tracker import Tracker
    from pli_slam_tpu_torch.ops.kernels import hamming
    from pli_slam_tpu_torch.utils.profile import SyncSpans

    tracker, traj, frames = run
    img_l, img_r, p_ref, n_ref = _kidnap(dev, tracker, traj)
    reset_counts()
    rec, err, states, inliers, attempts = _feed_kidnap(tracker, img_l, img_r, frames[-1]["t"], p_ref)
    launches = hamming.launches
    count_small_kernels()
    log(f"kidnap, 6a's tracker (inlier floors {tracker.cfg.tracking.min_inliers_track} / "
        f"{tracker.cfg.tracking.min_inliers_local_map}): states {states}, reported inliers {inliers}, relocalization "
        f"attempts (ms, accepted) {attempts}, recovered at kidnap frame {rec}, {err:.3f} m from the oracle-seeded "
        f"re-track ({n_ref} inliers there); gated_match launches {launches} [{smi}]")

    base = tracker.cfg
    cfg = dc.replace(base, tracking=dc.replace(base.tracking, recently_lost_sec=3.0, min_inliers_track=60,
                                               min_inliers_local_map=60))
    tr = Tracker(tracker.cam, cfg, dev)
    tr.streaming = True
    tr.span = SyncSpans(dev)
    reset_counts()
    for fr in frames[:20]:
        tr.process(fr["img_l"], fr["img_r"], fr["t"])
    launches_map = hamming.launches
    count_small_kernels()
    img_l, img_r, p_ref, n_ref = _kidnap(dev, tr, traj)
    held, orig = {"what": "kidnap 6b, the first relocalization under graphs"}, tr._relocalize

    def relocalize(frame):
        """The first attempt: the state before, then the call timed."""
        if "graphs" in held:
            return orig(frame)
        held["before"], held["frame"] = _rare_state(tr), graphs.tree_clone(frame)
        k0, t0 = kernel_counts(), time.perf_counter()
        ok = orig(frame)
        torch.cuda.synchronize(dev)
        held["graphs"] = dict(ret=ok, wall=time.perf_counter() - t0, kernels=tuple(
            b - a for a, b in zip(k0, kernel_counts())), after=_rare_state(tr))
        return ok

    tr._relocalize = relocalize
    reset_counts()
    traced = []
    with record_rare_args():
        rec, err, states, inliers, attempts = _feed_kidnap(tr, img_l, img_r, frames[19]["t"], p_ref, traced)
    launches_kid = hamming.launches
    count_small_kernels()
    launches += launches_map + launches_kid
    if "graphs" not in held or not traced:
        raise AssertionError("kidnap 6b: no relocalization was attempted under graphs")
    held["graphs"].update(launches=traced[0][0], graph_launches=traced[0][1])
    eager = _rare_eager(dev, tracker.cam, cfg, held, lambda te: te._relocalize(held["frame"]))
    log(_rare_line(held, eager) + f"; the graph side's launches are its whole frame's (the relocalization frames: "
        f"kernel launches, graph launches, ms {traced}) [{smi}]")
    if held["graphs"]["kernels"][2] < 1:
        raise AssertionError(f"kidnap 6b: the relocalization launched largest_eigvec {held['graphs']['kernels'][2]} "
                             f"times")
    worst = max(n for n, _, _ in traced)
    if worst > HOST_LAUNCH_LIMIT or any(ng == 0 for _, ng, _ in traced):
        raise AssertionError(f"kidnap 6b: a relocalization frame under graphs issued {worst} kernel launches (limit "
                             f"{HOST_LAUNCH_LIMIT}): a stage ran eagerly ({traced})")
    log(f"kidnap, floors 60 / 60 after 20 frames: states {states}, reported inliers {inliers}, relocalization attempts "
        f"(ms, accepted) {attempts}, recovered at kidnap frame {rec} with {err:.3f} m from the oracle-seeded re-track "
        f"({n_ref} inliers there); gated_match launches {launches_map} over the 20 frames and {launches_kid} over the "
        f"kidnap frames, {launches} in 6b; the second tracker's {warmups(tr)} [{smi}]")
    if n_ref < cfg.tracking.min_inliers_local_map:
        raise AssertionError(f"the oracle-seeded re-track of the kidnap view found only {n_ref} inliers")
    if rec is None:
        raise AssertionError(f"the kidnap was not relocalized within 6 frames (error {err} m)")
    return launches


def phase_atlas(dev, smi):
    """6c (see the module docstring): loss, a new map, and the merge back."""
    import numpy as np
    import torch

    from pli_slam_tpu_torch.frontend.tracker import Tracker, TrackingState
    from pli_slam_tpu_torch.ops.kernels import hamming
    from pli_slam_tpu_torch.utils import synthetic
    from pli_slam_tpu_torch.utils.profile import loop_config, slice_camera

    base, cam = loop_config(), slice_camera()
    cfg = dataclasses.replace(base, tracking=dataclasses.replace(base.tracking, recently_lost_sec=0.15),
                              loop=dataclasses.replace(base.loop, min_kf_gap=3))
    traj = synthetic.Trajectory(amp=(0.5, 0.35, 0.2), freq=(0.15, 0.19, 0.11), yaw_amp=0.25)
    frames = list(synthetic.make_sequence(cam, 24, dev, fps=cfg.fps, traj=traj, room_half=2.55))
    tracker = Tracker(cam, cfg, dev)
    tracker.streaming = True
    reset_counts()
    for fr in frames[:20]:
        tracker.process(fr["img_l"], fr["img_r"], fr["t"])
    n_kf1 = tracker.n_kf
    blank = torch.zeros_like(frames[0]["img_l"])
    for i in range(8):
        tracker.process(blank, blank, frames[19]["t"] + 0.05 * (i + 1))
    maps_after_blackout, state_after = tracker.atlas.n_maps(), tracker.state
    merge_ms = merged_at = None
    held, replays = {}, []
    hold_calls(tracker, {"_try_merge": (lambda tr: tr.atlas.n_maps() > 1, lambda tr, ret: ret)}, held)
    # every revisit frame traced, the merge frame's trace read (its host launches); the stages' checks after the loop
    with check_replays(INIT_STAGES, replays), FrameTrace(dev, per_frame=True) as trace:
        for k, fr in enumerate(frames[2:], 2):
            with trace.frame(k):
                tracker.process(fr["img_l"], fr["img_r"], fr["t"] + 2.0)
            if tracker.atlas.n_maps() == 1:
                merge_ms, merged_at = trace._ms[k], k
                trace.keep(k)
                break
    traced = trace.frames
    errs = []
    if merged_at is not None:
        R0, p0 = traj.pose(0.0)
        for fr in frames[merged_at + 1:merged_at + 5]:
            tracker.process(fr["img_l"], fr["img_r"], fr["t"] + 2.0)
            est_p = -(tracker.R.T @ tracker.t).cpu().numpy()
            errs.append(float(np.linalg.norm(est_p - R0.T @ (fr["p_w"] - p0))))
    torch.cuda.synchronize()
    launches = hamming.launches
    count_small_kernels()
    log(f"atlas: map 1 {n_kf1} keyframes; after the blackout {maps_after_blackout} maps ({state_after}); merged at "
        f"revisit frame {merged_at}, that frame {merge_ms if merge_ms is None else round(merge_ms, 2)} ms; position "
        f"errors after the merge {[round(e, 4) for e in errs]} m; gated_match launches {launches}; {warmups(tracker)} "
        f"[{smi}]")
    if n_kf1 < 3 or maps_after_blackout != 2 or state_after != TrackingState.NOT_INITIALIZED:
        raise AssertionError(f"the blackout left {maps_after_blackout} maps, state {state_after}")
    if merged_at is None or not errs or max(errs) >= 0.5:
        raise AssertionError(f"merge at {merged_at}, position errors {errs}")
    # the merge frame: Atlas.merge_active_into stays eager (as the reference's merge_maps), so its host launches
    # are reported, not held to HOST_LAUNCH_LIMIT
    log(f"atlas: the merge frame under graphs (traced, the trace read in {trace.export_s:.1f} s; frame, kernel "
        f"launches, graph launches, ms) {traced}")
    init_paths("atlas", dev, tracker, held, replays, traced, merged_at, smi, limited=False)
    return launches


# ---------------------------------------------------------------------------
# Phases 7-8 and the rectifier: the other sensors through the System facade
# ---------------------------------------------------------------------------

N_LOCALIZE = 5
# The reference (pli_slam_tpu on its accelerator branch, run on a CPU) over the same frames through its own
# System, streaming (tests/test_torch_mono_rgbd.py::test_full_width_reference_runs, slow): RGB-D ATE
# 0.0124 m over the 3.20 m path on its own renderer's images, 0.1752 m on the port's, which are the
# card's (rendered on the host, FRAME0_SHA256). On this deployment (TUM3's bf 40 puts the far-point cutoff
# inside the room) windowed BA throws keyframes 0.2-0.4 m off in both packages (ROADMAP queue 3 B3): the
# largest aligned error is 0.383 m in the reference's run and 0.288 m in the card's, and phase 7 keeps that
# configuration so that the defect stays in view. Since the Hough votes and the PGO sum in fixed point on
# the card, its runs are bit-identical: ATE 0.120358 m in four runs of one call and in the whole script
# (PERF.md, section 6, the dataset ingest path). The bound is that value with a margin of 1.5x, so a change that moves the run
# further is caught; phase 9b holds the same frames, quantised to 8 bits and read back through the TUM
# loader (0.0577 m), to the same bound.
REF_ATE_RGBD = (0.0124, 0.1752)  # the reference on its own images, on the port's (the card's)
RGBD_ATE_CARD = 0.120358
RGBD_ATE_BOUND = 1.5 * RGBD_ATE_CARD
# SHA-256 of phase 4's first stereo pair, float32 bytes: the host renders, so the card tracks a CPU's pixels
FRAME0_SHA256 = "0489db0458d05833810cc36832a2ba22a9125f3eb793c7acc7b7bd6afff1b8e0"
# Phase 9c: the reference's scripts/run_kitti.py on the same written folder, at full width on a CPU
# (tests/test_torch_drivers.py::test_full_width_reference_kitti, slow): ATE 0.0289 m over 30 frames, 6
# keyframes. The card's run (bit-reproducible): 0.0425 m (PERF.md, section 6, the dataset ingest path). The bound is a
# divergence guard at about 3.5x the reference's.
REF_ATE_KITTI = 0.0289
KITTI_ATE_BOUND = 0.10
# Mono, same reference: initialized at frame 1 (its two-view reconstruction succeeds on consecutive 20 fps
# frames of this scene at 752x480, so no stride is needed), 39 of 40 frames tracked, 14 keyframes,
# Sim(3)-aligned ATE 0.5186 m over the 4.96 m path on the port's (the card's) images, 0.519 m on its own.
# The port draws its own RANSAC hypotheses (the reference's cannot be reproduced in torch), so its two-view
# initialization may pick another sample: the initialization may come MONO_INIT_MARGIN frames later, and
# the ATE bound is 2x the reference's.
REF_INIT_MONO_OWN, REF_ATE_MONO_OWN = 1, 0.519  # the reference on its own images
REF_INIT_MONO = 1
MONO_INIT_MARGIN = 2
REF_ATE_MONO = 0.5186
MONO_ATE_BOUND = 1.0


def _frame_times(ms):
    import numpy as np

    ms = np.asarray(ms)
    return (f"fps {1e3 / ms.mean():.3f}, p50 {np.percentile(ms, 50):.2f} ms, "
            f"p99 {np.percentile(ms, 99):.2f} ms")


def phase_rgbd(dev, smi):
    """Phase 7: RGB-D through `System.track_rgbd` (see the module docstring)."""
    import numpy as np
    import torch

    from pli_slam_tpu_torch.ops.kernels import hamming
    from pli_slam_tpu_torch.system import System
    from pli_slam_tpu_torch.utils import synthetic
    from pli_slam_tpu_torch.utils import trajectory as tio
    from pli_slam_tpu_torch.utils.profile import N_FRAMES_RGBD, rgbd_camera, rgbd_config

    cfg, cam = rgbd_config(), rgbd_camera()
    t0 = time.perf_counter()
    frames = list(synthetic.make_sequence(cam, N_FRAMES_RGBD + N_LOCALIZE, dev, fps=cfg.fps, with_depth=True))
    frames, ahead = frames[:N_FRAMES_RGBD], frames[N_FRAMES_RGBD:]  # the second System continues where the map ends
    torch.cuda.synchronize()
    log(f"rgbd: rendered {N_FRAMES_RGBD + N_LOCALIZE} frames {cam.width}x{cam.height} with depth in "
        f"{time.perf_counter() - t0:.2f} s")
    sysm = System(cam, cfg, device=dev)
    sysm.tracker.streaming = True
    reset_counts()
    ms = []
    for i, fr in enumerate(frames):
        f0 = time.perf_counter()
        info = sysm.track_rgbd(fr["img_l"], fr["depth"], fr["t"])
        if i > 0:
            ms.append((time.perf_counter() - f0) * 1e3)
        if not np.all(np.isfinite(info["p_w"])):
            raise AssertionError(f"rgbd: frame {i} pose not finite")
    torch.cuda.synchronize()
    launches = hamming.launches
    count_small_kernels()
    tracker = sysm.tracker
    ok_frames = _consumed_ok(tracker)
    sysm.shutdown()
    est = np.stack([p for _, _, p in tracker.trajectory])
    gt = np.stack([fr["p_w"] for fr in frames])
    if est.shape != gt.shape or not np.all(np.isfinite(est)):
        raise AssertionError(f"rgbd: trajectory shape {est.shape} / finite {np.all(np.isfinite(est))}")
    ate = tio.ate_rmse(est, gt)
    n_fused = N_FRAMES_RGBD - 1
    s_, R_, t_ = tio.align_umeyama(est, gt)
    worst = float(np.linalg.norm(s_ * est @ R_.T + t_ - gt, axis=1).max())
    log(f"rgbd: System.track_rgbd over {N_FRAMES_RGBD} frames, frames 1-{n_fused}: {_frame_times(ms)}; ATE {ate:.4f} m "
        f"(bound {RGBD_ATE_BOUND:.4f} m; the reference: {REF_ATE_RGBD[0]} m on its own images, {REF_ATE_RGBD[1]} m on "
        f"these), largest aligned error {worst:.4f} m (windowed BA's RGB-D excursions, queue 3 B3), {tracker.n_kf} "
        f"keyframes, ok frames {ok_frames}/{N_FRAMES_RGBD}, "
        f"gated_match launches {launches} ({launches / n_fused:.2f} per fused frame); {warmups(tracker)} [{smi}]")

    out = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(out, exist_ok=True)
    map_path = os.path.join(out, "rgbd_map.npz")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sysm.save_map(map_path)
    t_save = (time.perf_counter() - t0) * 1e3
    loaded = System(cam, cfg, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loaded.load_map(map_path)
    torch.cuda.synchronize()
    t_load = (time.perf_counter() - t0) * 1e3
    loaded.activate_localization_mode()
    n_pts, n_kf = int(loaded.tracker.pstore.valid.sum()), loaded.tracker.n_kf
    reset_counts()
    states, ms_loc = [], []
    for fr in ahead:
        f0 = time.perf_counter()
        states.append(loaded.track_rgbd(fr["img_l"], fr["depth"], fr["t"])["state"])
        ms_loc.append((time.perf_counter() - f0) * 1e3)
    launches_loc = hamming.launches
    count_small_kernels()
    grown = (int(loaded.tracker.pstore.valid.sum()) - n_pts, loaded.tracker.n_kf - n_kf)
    lines = {}
    for name in ("trajectory_tum", "trajectory_euroc", "trajectory_kitti", "keyframe_trajectory_tum"):
        path = os.path.join(out, f"rgbd_{name}.txt")
        getattr(sysm, f"save_{name}")(path)
        with open(path) as f:
            lines[name] = len(f.readlines())
    log(f"rgbd: save_map {t_save:.2f} ms ({os.path.getsize(map_path) / 2**20:.2f} MiB), load_map into a new System "
        f"{t_load:.2f} ms; localization mode over the next {N_LOCALIZE} frames: states {states}, map grown by "
        f"{grown[0]} points / {grown[1]} keyframes, {np.mean(ms_loc):.2f} ms a frame, gated_match launches "
        f"{launches_loc}; trajectory files (lines) {lines} [{smi}]")
    for name in os.listdir(out):
        os.remove(os.path.join(out, name))
    if ok_frames < 0.9 * N_FRAMES_RGBD:
        raise AssertionError(f"rgbd: only {ok_frames}/{N_FRAMES_RGBD} frames tracked")
    if not ate < RGBD_ATE_BOUND:
        raise AssertionError(f"rgbd: ATE {ate} m >= {RGBD_ATE_BOUND} m")
    if launches < 2 * n_fused:
        raise AssertionError(f"rgbd: gated_match launched {launches} times for {n_fused} fused frames")
    if any(s != "OK" for s in states) or grown != (0, 0) or loaded.tracker.n_kf != tracker.n_kf:
        raise AssertionError(f"rgbd: localization after load_map: states {states}, map grown by {grown}")
    if lines["trajectory_tum"] != N_FRAMES_RGBD or lines["keyframe_trajectory_tum"] != tracker.n_kf:
        raise AssertionError(f"rgbd: trajectory files {lines}")
    return launches + launches_loc, n_fused + N_LOCALIZE, frames  # the loaded map's frames run the fused step too


def phase_mono(dev, smi):
    """Phase 8: monocular through `System.track_monocular` (see the module docstring)."""
    import numpy as np
    import torch

    from pli_slam_tpu_torch.frontend.tracker import TrackingState
    from pli_slam_tpu_torch.ops.kernels import hamming
    from pli_slam_tpu_torch.system import System
    from pli_slam_tpu_torch.utils import trajectory as tio
    from pli_slam_tpu_torch.utils.profile import sensor_run

    cfg, cam, frames = sensor_run("mono", dev)
    sysm = System(cam, cfg, device=dev)
    held, replays = {}, []
    hold_calls(sysm.tracker, {"_initialize_mono": (lambda tr: True, lambda tr, ret: tr.state == TrackingState.OK),
                              "_create_keyframe": (lambda tr: tr.n_kf >= 2, lambda tr, ret: True)}, held)
    reset_counts()
    ms, states = [], []
    init = None
    kf_at = set()
    with check_replays(INIT_STAGES, replays), FrameTrace(dev) as trace:  # every frame traced, the checks after
        for i, fr in enumerate(frames):
            n_kf0 = sysm.tracker.n_kf
            with trace.frame(i):
                info = sysm.track_monocular(fr["img_l"], fr["t"])
            dt = trace._ms[i]
            if sysm.tracker.n_kf > n_kf0:
                kf_at.add(i)
            states.append(info["state"])
            if init is None and info["state"] == TrackingState.OK:
                init, init_ms, init_launches = i, dt, hamming.launches
            elif init is not None:
                ms.append(dt)
    traced = trace.frames
    kf_frames = [f for f in traced if f[0] in kf_at and f[0] != init]
    torch.cuda.synchronize()
    launches = hamming.launches
    count_small_kernels()
    tracker = sysm.tracker
    sysm.shutdown()
    est = np.stack([p for _, _, p in tracker.trajectory])
    gt = np.stack([fr["p_w"] for fr in frames])
    ok_frames = sum(s == TrackingState.OK for s in states)
    if init is None:
        raise AssertionError(f"mono: never initialized over {len(frames)} frames")
    if est.shape != gt.shape or not np.all(np.isfinite(est)):
        raise AssertionError(f"mono: trajectory shape {est.shape} / finite {np.all(np.isfinite(est))}")
    ate = tio.ate_rmse(est, gt, with_scale=True)
    n_tracked = len(frames) - init - 1
    log(f"mono: System.track_monocular over {len(frames)} consecutive frames: initialized at frame {init} "
        f"(the reference: {REF_INIT_MONO}), that frame {init_ms:.1f} ms; frames {init + 1}-{len(frames) - 1} (traced, "
        f"each synchronised): {_frame_times(ms)}; Sim(3) ATE {ate:.4f} m (the reference on these frames: "
        f"{REF_ATE_MONO} m), {tracker.n_kf} keyframes, ok frames {ok_frames}/{len(frames)}, gated_match launches "
        f"{launches} ({init_launches} up to the initialization, {(launches - init_launches) / max(n_tracked, 1):.2f} "
        f"per frame after it) [{smi}]")
    if init > REF_INIT_MONO + MONO_INIT_MARGIN:
        raise AssertionError(f"mono: initialized at frame {init}, the reference at {REF_INIT_MONO}")
    if ok_frames < 0.6 * len(frames):
        raise AssertionError(f"mono: only {ok_frames}/{len(frames)} frames tracked")
    if not ate < MONO_ATE_BOUND:
        raise AssertionError(f"mono: Sim(3) ATE {ate} m >= {MONO_ATE_BOUND} m")
    if launches - init_launches < 2 * n_tracked:
        raise AssertionError(f"mono: gated_match launched {launches - init_launches} times for {n_tracked} frames")
    if tracker.cuda_graphs:
        launch_limited("mono: the initialization frame and the keyframes", [f for f in traced if f[0] == init]
                       + kf_frames)
    log(f"mono: the frames under graphs (traced, the trace read in {trace.export_s:.1f} s; kernel launches, graph "
        f"launches, ms): the initialization "
        f"{[f[1:] for f in traced if f[0] == init]}, the {len(kf_frames)} keyframes {[f[1:] for f in kf_frames]}; "
        f"the {len(traced) - len(kf_frames) - 2} tracking-only frames at most "
        f"{max((f[1] for f in traced if f[0] > init and f not in kf_frames), default=0)} kernel launches [{smi}]")
    init_paths("mono", dev, tracker, held, replays, traced, init, smi)
    launches += mono_planted_reloc(dev, smi, tracker, frames, est, gt)
    return launches, len(frames)


def mono_planted_reloc(dev, smi, tracker, frames, est, gt) -> int:
    """Phase 8's planted relocalization: the tracker's pose set to the
    identity and its state to lost, then the last frame of its own sequence
    relocalized through the stages (the mono PnP: the 6-point DLT on
    svd_small, under graphs). It must be re-tracked, and the Sim(3) ATE of
    the run with the relocalized pose added (against that frame's ground
    truth) must stay inside phase 8's bound. Returns its gated_match launches."""
    import numpy as np
    import torch

    from pli_slam_tpu_torch.frontend.tracker import TrackingState
    from pli_slam_tpu_torch.ops.kernels import hamming
    from pli_slam_tpu_torch.utils import trajectory as tio

    k = len(frames) - 1
    frame = tracker._build_host(*tracker._images(frames[k]["img_l"]))
    tracker.R, tracker.t = torch.eye(3, device=dev), torch.zeros(3, device=dev)
    tracker._reset_motion()
    tracker.state = TrackingState.LOST
    reset_counts()
    t0 = time.perf_counter()
    with record_rare_args():
        ok = tracker._relocalize(frame)
    torch.cuda.synchronize(dev)
    ms = (time.perf_counter() - t0) * 1e3
    launches, (_, _, n_eig, n_svd) = hamming.launches, kernel_counts()
    count_small_kernels()
    p = -(tracker.R.T @ tracker.t).cpu().numpy()
    ate = tio.ate_rmse(np.vstack([est, p]), np.vstack([gt, gt[k]]), with_scale=True)
    log(f"mono: planted relocalization of frame {k} from the identity pose, lost: re-tracked {ok} in {ms:.1f} ms "
        f"(graphs {tracker.cuda_graphs}), {float(np.linalg.norm(p - est[k])):.4f} map units from the run's own pose "
        f"there; Sim(3) ATE with it {ate:.4f} m (bound {MONO_ATE_BOUND}); launches: svd_small {n_svd}, "
        f"largest_eigvec {n_eig}, gated_match {launches} [{smi}]")
    if not ok or tracker.state != TrackingState.OK:
        raise AssertionError(f"mono: the planted relocalization of frame {k} failed")
    if not ate < MONO_ATE_BOUND:
        raise AssertionError(f"mono: Sim(3) ATE {ate} m with the relocalized pose >= {MONO_ATE_BOUND} m")
    if n_svd < 2:
        raise AssertionError(f"mono: the relocalization launched svd_small {n_svd} times (the DLT's A and M)")
    return launches


def phase_rectifier(dev, smi):
    """The EuRoC rectifier on the card against the CPU on a 752x480 pair
    (bilinear in float32: within 1e-3 grey levels), and one call timed."""
    import torch

    from pli_slam_tpu_torch.ops.rectify import euroc_rectifier
    from pli_slam_tpu_torch.utils import synthetic
    from pli_slam_tpu_torch.utils.profile import slice_camera

    fr = next(iter(synthetic.make_sequence(slice_camera(), 1, "cpu")))
    rect_c, rect_g = euroc_rectifier("cpu"), euroc_rectifier(dev)
    out_c = rect_c(fr["img_l"], fr["img_r"])
    args = (fr["img_l"].to(dev), fr["img_r"].to(dev))
    out_g = rect_g(*args)
    err = max((g.cpu() - c).abs().max().item() for g, c in zip(out_g, out_c))
    for _ in range(3):
        rect_g(*args)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    n = 20
    start.record()
    for _ in range(n):
        rect_g(*args)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / n
    log(f"rectifier: euroc_rectifier() on a 752x480 pair, card vs CPU max diff {err:.2e} grey levels; one call "
        f"(both images) {ms:.4f} ms (CUDA events, mean of {n}) [{smi}]")
    if not err <= 1e-3:
        raise AssertionError(f"rectifier: card and CPU differ by {err}")


# ---------------------------------------------------------------------------
# Phase 9: the dataset ingest path, the port's drivers on written dataset folders
# ---------------------------------------------------------------------------

KITTI_CAM = dict(fx=KITTI_FX, fy=KITTI_FX, cx=607.1928, cy=185.2157, baseline=0.537, width=1241, height=376)
KITTI_TRAJ = dict(amp=(1.2, 0.3, 1.5), freq=(0.1, 0.12, 0.08), yaw_amp=0.3, yaw_freq=0.1)  # forward, car-like
N_FRAMES_KITTI = 30
N_FRAMES_LIVE = 40
N_FRAMES_VOCAB = 12  # frames of 9a's folder the vocabularies are trained on
N_FRAMES_VOCAB_TRACK = 20  # phase 4's first frames, tracked with the trained vocabularies


def _plot_args():
    """`--no-plots` when the card's Python has no matplotlib (said in the log)."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return ["--no-plots"], "no matplotlib: the drivers run with --no-plots"
    return [], "matplotlib found: the drivers write their plots"


def _driver_line(name, summary, launches, smi):
    ate = summary.get("ate")
    return (f"{name}: {summary['frames']} frames, fps {summary['fps']:.3f}, p50 {summary['p50_ms']:.2f} ms, p99 "
            f"{summary['p99_ms']:.2f} ms (each frame synchronised), ingest {summary['ingest_ms']:.2f} ms and track "
            f"{summary['track_ms']:.2f} ms a frame; ATE {'none' if ate is None else f'{ate:.4f} m'}, "
            f"{summary['n_kf']} keyframes; gated_match launches {launches} [{smi}]")


def _run_driver(module, argv):
    """A driver's main() in this process; its launches and summary.json."""
    import importlib

    from pli_slam_tpu_torch.ops.kernels import hamming

    out = argv[argv.index("--out") + 1]
    reset_counts()
    rc = importlib.import_module(f"pli_slam_tpu_torch.scripts.{module}").main(argv)
    launches = hamming.launches
    count_small_kernels()
    if rc != 0:
        raise AssertionError(f"{module} returned {rc}")
    with open(os.path.join(out, "summary.json")) as f:
        return json.load(f), launches


def phase_euroc(dev, smi, work, vi, plots):
    """9a: phase 5's frames written as an ASL folder (8-bit PNGs, all five row
    filters, 200 Hz imu0/data.csv, ground truth) with a reference-style YAML
    (phase 5's camera, Tbc = identity, no rectification blocks), through
    `run_euroc --stereo-imu --native-loader --config`. Guards: the IMU slices
    read back equal phase 5's samples; phase 5's ATE bounds."""
    import numpy as np

    from pli_slam_tpu_torch.utils import dataset_writers as dw
    from pli_slam_tpu_torch.utils import trajectory as tio
    from pli_slam_tpu_torch.utils.euroc import EurocSequence
    from pli_slam_tpu_torch.utils.profile import slice_camera

    cfg, frames = vi
    root, yaml, out = os.path.join(work, "euroc"), os.path.join(work, "euroc.yaml"), os.path.join(work, "out_euroc")
    t0 = time.perf_counter()
    dw.write_euroc(root, frames, cfg.fps, filter_type=None)
    dw.write_euroc_yaml(yaml, slice_camera(), cfg)
    t_write = time.perf_counter() - t0
    n_imu = 0
    for k, fr in enumerate(EurocSequence(root).frames()):
        if k == 0:
            continue  # the loader's first frame has no IMU slice
        mem = frames[k]
        if not (np.array_equal(fr["imu_gyro"], mem["imu_gyro"]) and np.array_equal(fr["imu_acc"], mem["imu_acc"])
                and np.abs(fr["imu_stamps"] - mem["imu_stamps"]).max() < 1e-6):
            raise AssertionError(f"euroc: frame {k}'s IMU slice read back differs from phase 5's samples")
        n_imu += len(fr["imu_gyro"])
    summary, launches = _run_driver("run_euroc", [root, "--stereo-imu", "--native-loader", "--config", yaml,
                                                  "--out", out, *plots])
    est = np.stack([p for _, _, p in tio.load_tum(os.path.join(out, "trajectory_tum.txt"))])
    gt = np.stack([fr["p_w"] for fr in frames])
    init = summary["imu_init_frame"]
    n_head = len(frames) if init is None else init + 1
    ate_head = tio.ate_rmse(est[:n_head], gt[:n_head])
    log(f"euroc: wrote {len(frames)} stereo pairs {frames[0]['img_l'].shape[1]}x{frames[0]['img_l'].shape[0]} and "
        f"{n_imu} IMU samples in {t_write:.2f} s; IMU slices read back equal phase 5's; run_euroc --stereo-imu "
        f"--native-loader --config: IMU initialized at frame {init}, ATE of frames 0-{n_head - 1} {ate_head:.4f} m")
    log(_driver_line("euroc", summary, launches, smi))
    if summary["frames"] != len(frames) or est.shape != gt.shape or not np.all(np.isfinite(est)):
        raise AssertionError(f"euroc: {summary['frames']} frames run, trajectory {est.shape}")
    if not ate_head < 0.10 or not summary["ate"] < 2.0:
        raise AssertionError(f"euroc: ATE {ate_head} m up to the IMU initialization, {summary['ate']} m over the run")
    if launches < 2 * (len(frames) - 1):
        raise AssertionError(f"euroc: gated_match launched {launches} times for {len(frames) - 1} tracked frames")
    return root, yaml, launches, len(frames)


def phase_tum(dev, smi, work, rgbd_frames, plots):
    """9b: phase 7's frames as a TUM RGB-D folder (8-bit RGB, 16-bit depth at
    factor 5000, depth stamped 4 ms after its image), through `run_tum
    --freiburg 3`. Guard: phase 7's."""
    from pli_slam_tpu_torch.utils import dataset_writers as dw
    from pli_slam_tpu_torch.utils.datasets import TumRgbdSequence

    root, out = os.path.join(work, "tum"), os.path.join(work, "out_tum")
    dw.write_tum(root, rgbd_frames, 30.0)
    n_assoc = len(TumRgbdSequence(root))
    summary, launches = _run_driver("run_tum", [root, "--freiburg", "3", "--out", out, *plots])
    log(f"tum: {len(rgbd_frames)} frames written, {n_assoc} associated across the 4 ms stamp offset")
    log(_driver_line("tum", summary, launches, smi))
    if n_assoc != len(rgbd_frames) or summary["frames"] != n_assoc:
        raise AssertionError(f"tum: {n_assoc} of {len(rgbd_frames)} frames associated, {summary['frames']} run")
    if not summary["ate"] < RGBD_ATE_BOUND:
        raise AssertionError(f"tum: ATE {summary['ate']} m >= {RGBD_ATE_BOUND} m")
    if launches < 2 * (summary["frames"] - 1):
        raise AssertionError(f"tum: gated_match launched {launches} times for {summary['frames'] - 1} fused frames")
    return launches, summary["frames"]


def kitti_frames(dev):
    """Phase 9c's frames: KITTI 00's rectified stereo camera (1241x376, baseline
    0.537 m) at 10 fps on a forward, car-like trajectory through the room."""
    from pli_slam_tpu_torch.ops.camera import Camera
    from pli_slam_tpu_torch.utils import synthetic

    c = KITTI_CAM
    cam = Camera.pinhole(fx=c["fx"], fy=c["fy"], cx=c["cx"], cy=c["cy"], bf=c["fx"] * c["baseline"],
                         width=c["width"], height=c["height"])
    return list(synthetic.make_sequence(cam, N_FRAMES_KITTI, dev, fps=10.0, traj=synthetic.Trajectory(**KITTI_TRAJ)))


def phase_kitti(dev, smi, work, plots):
    """9c: KITTI at 1241x376 with 2000 ORB through `run_kitti`. Guard: set from
    the reference's run of the same folder (REF_ATE_KITTI)."""
    from pli_slam_tpu_torch.utils import dataset_writers as dw

    c = KITTI_CAM
    root, out = os.path.join(work, "kitti"), os.path.join(work, "out_kitti")
    dw.write_kitti(root, kitti_frames("cpu"), 10.0, c["fx"], c["fy"], c["cx"], c["cy"], c["baseline"])
    summary, launches = _run_driver("run_kitti", [root, "--out", out, *plots])
    log(_driver_line(f"kitti (the reference on this folder: ATE {REF_ATE_KITTI} m)", summary, launches, smi))
    if summary["frames"] != N_FRAMES_KITTI or not summary["ate"] < KITTI_ATE_BOUND:
        raise AssertionError(f"kitti: {summary['frames']} frames, ATE {summary['ate']} m (bound {KITTI_ATE_BOUND} m)")
    if launches < 2 * (N_FRAMES_KITTI - 1):
        raise AssertionError(f"kitti: gated_match launched {launches} times for {N_FRAMES_KITTI - 1} fused frames")
    return launches, N_FRAMES_KITTI


def phase_live(dev, smi, work, root, yaml):
    """9d: `run_live` on 9a's folder at 20 Hz for 40 frames: at the port's rate
    most frames are dropped by the bounded queue, and those still queued when
    the feed stops are not tracked (the synchronizer returns on `stop()`, as
    the reference's does). Guard: every delivered frame is tracked or
    reported lost, and the run ends."""
    out = os.path.join(work, "out_live")
    summary, launches = _run_driver("run_live", [root, "--rate", "20", "--frames", str(N_FRAMES_LIVE), "--config", yaml,
                                                 "--out", out])
    log(f"live: pushed {summary['pushed']} frames at 20 Hz, delivered {summary['delivered']}, dropped "
        f"{summary['dropped']} by the bounded queue, {summary['left']} left in it when the feed stopped, in "
        f"{summary['seconds']:.2f} s; states {summary['states']}, "
        f"{summary['n_kf']} keyframes; gated_match launches {launches} [{smi}]")
    if summary["pushed"] != N_FRAMES_LIVE or summary["delivered"] < 1:
        raise AssertionError(f"live: {summary}")
    if sum(summary["states"].values()) != summary["delivered"]:
        raise AssertionError(f"live: delivered {summary['delivered']} frames but reported {summary['states']}")
    return launches, summary["delivered"]


def phase_vocab(dev, smi, work, root, room):
    """9e: `train_vocab --euroc` on 9a's folder (1024 point and 1024 line
    words), the trained `words` on the card against the CPU, then a Tracker
    with both trained vocabularies over phase 4's frames (phase 4's ATE
    guard). Prints the keyframes' BoW rows and the last keyframe's best
    loop-query score."""
    import numpy as np
    import torch

    from pli_slam_tpu_torch.frontend import step as step_mod
    from pli_slam_tpu_torch.frontend.tracker import Tracker
    from pli_slam_tpu_torch.ops import orb
    from pli_slam_tpu_torch.ops.kernels import hamming
    from pli_slam_tpu_torch.scripts import train_vocab
    from pli_slam_tpu_torch.utils import synthetic
    from pli_slam_tpu_torch.utils.profile import slice_camera, slice_config
    from pli_slam_tpu_torch.worldmap.vocab import TrainedVocabulary

    prefix = os.path.join(work, "vocab")
    t0 = time.perf_counter()
    if train_vocab.main(["--euroc", root, "--out", prefix, "--words", "1024", "--line-words", "1024",
                         "--frames", str(N_FRAMES_VOCAB)]) != 0:
        raise AssertionError("train_vocab failed")
    t_train = time.perf_counter() - t0
    voc_pt, voc_ln = TrainedVocabulary.load(prefix + "_pt.npz"), TrainedVocabulary.load(prefix + "_ln.npz")
    cfg, cam = slice_config(), slice_camera()
    room = room[:N_FRAMES_VOCAB_TRACK]
    f = orb.extract(room[0]["img_l"].to(dev), cfg.orb)
    w_dev = voc_pt.words(f.desc, f.valid).cpu()
    w_cpu = voc_pt.words(f.desc.cpu(), f.valid.cpu())
    if not torch.equal(w_dev, w_cpu):
        raise AssertionError(f"vocab: words differ between card and CPU in {(w_dev != w_cpu).sum().item()} rows")
    tracker = Tracker(cam, cfg, dev, vocab_pt=voc_pt, vocab_ln=voc_ln)
    tracker.streaming = True
    reset_counts()
    for fr in room:
        tracker.process(fr["img_l"], fr["img_r"], fr["t"])
    tracker.finalize()
    launches = hamming.launches
    count_small_kernels()
    est, gt = tracker.positions(), np.stack([fr["p_w"] for fr in room])
    ate = synthetic.ate_rmse(est, gt)
    db, n_kf = tracker.bow_db, tracker.n_kf
    rows = int(db.valid.sum())
    nnz = (db.hist_pt[:n_kf] > 0).sum(1).tolist()
    k = n_kf - 1
    excl = torch.arange(db.valid.shape[0], device=dev) >= max(n_kf - cfg.loop.min_kf_gap, 0)
    _, scores = step_mod.vocab_query(db, db.hist_pt[k], db.hist_ln[k], excl, n_best=step_mod.N_LOOP_CANDS,
                                     covis=tracker.kstore.covis)
    log(f"vocab: train_vocab on {N_FRAMES_VOCAB} frames of 9a's folder in {t_train:.2f} s: {voc_pt.n_words} point and "
        f"{voc_ln.n_words} line words; words on the card equal the CPU's for {int(f.valid.sum())} descriptors; "
        f"Tracker(vocab_pt=, vocab_ln=) over phase 4's {len(room)} frames: ATE {ate:.4f} m, {n_kf} keyframes, "
        f"{rows} BoW rows ({db.hist_pt.shape[1]} / {db.hist_ln.shape[1]} words wide; words per keyframe {nnz}), "
        f"the last keyframe's loop query best score {float(scores[0]):.4f}; gated_match launches {launches} [{smi}]")
    # keyframe 0, made by the map's initialization, gets no BoW row (in the reference too)
    if rows != n_kf - 1 or db.hist_pt.shape[1] != voc_pt.n_words or db.hist_ln.shape[1] != voc_ln.n_words:
        raise AssertionError(f"vocab: {rows} BoW rows for {n_kf} keyframes, widths {tuple(db.hist_pt.shape)}")
    if not ate < 0.10:
        raise AssertionError(f"vocab: ATE {ate} m >= 0.10 m")
    if launches < 2 * (len(room) - 1):
        raise AssertionError(f"vocab: gated_match launched {launches} times for {len(room) - 1} fused frames")
    return launches, len(room)


def phase_ingest(dev, smi, vi, rgbd_frames, room):
    """Phase 9 (see the module docstring): 9a-9e in a scratch folder under build/."""
    import shutil
    import tempfile

    plots, said = _plot_args()
    log(f"ingest: {said}")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="phase9_", dir=os.path.join(ROOT, "build"))
    try:
        root, yaml, l_euroc, n_euroc = phase_euroc(dev, smi, work, vi, plots)
        counts = {"euroc": (l_euroc, n_euroc), "tum": phase_tum(dev, smi, work, rgbd_frames, plots),
                  "kitti": phase_kitti(dev, smi, work, plots), "live": phase_live(dev, smi, work, root, yaml),
                  "vocab": phase_vocab(dev, smi, work, root, room)}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return counts


# ---------------------------------------------------------------------------
# Phases 10-12: the fisheye rig, mono-inertial and RGB-D-inertial
# ---------------------------------------------------------------------------

# The reference (pli_slam_tpu on its accelerator branch, run on a CPU) over the same frames, the port's
# renderer's (tests/full_width_slice6.py, run by the `slow` tests of tests/test_torch_fisheye.py,
# test_torch_mono_inertial.py and test_torch_rgbd_inertial.py). FISHEYE0_SHA256 is phase 10's first KB8
# pair, which tests/test_torch_fisheye.py holds on the CPU.
FISHEYE0_SHA256 = "22cb69e3e886c2f6203c61877b25849e551901c49753cdd7d1fff913e3c3eaa8"
REF_FISHEYE = dict(init=13, ate=0.1432, n_kf=14)  # 10a
# 10b: the reference's fused stereo-inertial step does not compile at 512x512 on a CPU (XLA's LLVM runs out of
# memory), so its run stops at the IMU initialization and the whole run has no reference figure
REF_FISHEYE_VI = dict(map_init=13, imu_init=32, ate_pre=0.0360, ate_init=0.0610)
REF_MONO_VI = dict(mono_init=1, imu_init=30, scale=0.9703, ate_pre_sim3=0.3496, ate_init_sim3=0.3587, ate_sim3=0.9071,
                   ratio=0.5290)  # 11
REF_RGBD_VI = dict(imu_init=45, ate_pre=0.0414, ate_init=0.0326, ate=1.0088)  # 12
INIT_MARGIN = 3  # frames an initialization may come later or earlier than the reference's
FISHEYE_ATE_BOUND = 2.0 * REF_FISHEYE["ate"]
FISHEYE_VI_ATE_PRE_BOUND = 2.0 * REF_FISHEYE_VI["ate_pre"]
FISHEYE_VI_ATE_BOUND = 5.0
MONO_VI_ATE_PRE_BOUND = 1.0
RGBD_VI_ATE_PRE_BOUND = RGBD_ATE_BOUND  # phase 7's, on the same deployment
RGBD_VI_ATE_BOUND = 2.0


def _gravity_error_deg(tracker) -> float:
    """The angle between the tracker's gravity and the truth in its world
    (the first camera's frame on the default room trajectory)."""
    import numpy as np

    from pli_slam_tpu_torch.utils import synthetic

    R0, _ = synthetic.Trajectory().pose(0.0)
    g_true = R0.T @ np.array([0.0, 0.0, -9.81])
    g = tracker.gravity_w.cpu().numpy().astype(np.float64)
    return float(np.degrees(np.arccos(np.clip(g @ g_true / np.linalg.norm(g) / 9.81, -1.0, 1.0))))


def _fisheye_association_ms(cam, cfg, fr, dev):
    """The fisheye frame's dense L<->R association (the epipolar gate, the
    [N, N] Hamming matrix, nearest neighbours with the ratio test, mutual
    consistency) on one pair's features, timed with CUDA events (mean of 20)."""
    import dataclasses as dc

    import torch

    from pli_slam_tpu_torch.frontend.frame import undistort_uv
    from pli_slam_tpu_torch.ops import matching, orb
    from pli_slam_tpu_torch.solve import triangulate as tri
    from pli_slam_tpu_torch.utils.kernel_bench import eager_ms
    from pli_slam_tpu_torch.utils.profile import fisheye_rig

    fl, fr_ = orb.extract(fr["img_l"], cfg.orb), orb.extract(fr["img_r"], cfg.orb)
    uv_l, uv_r = undistort_uv(cam, fl.uv), undistort_uv(cam, fr_.uv)
    pin = dc.replace(cam, model=0)
    T = torch.as_tensor(fisheye_rig(), device=dev)
    eye, zero = torch.eye(3, device=dev), torch.zeros(3, device=dev)

    def associate():
        gate = tri.epipolar_gate(pin, eye, zero, T[:3, :3], T[:3, 3], uv_l, uv_r)
        dist = matching.hamming_matrix(fl.desc, fr_.desc)
        idx, _, ok = matching.match_nn(dist, fl.valid, fr_.valid, gate, max_dist=cfg.match.orb_th_high,
                                       ratio=cfg.match.nn_ratio)
        return matching.mutual_consistency(idx, ok, dist, fl.valid, fr_.valid, gate)

    n_pairs = int(associate().sum())
    return eager_ms(associate, iters=20), int(fl.valid.sum()), int(fr_.valid.sum()), n_pairs


def phase_fisheye(dev, smi):
    """Phase 10 (see the module docstring): 10a the fused visual step, 10b
    the stereo-inertial path, both on TUM-VI's KB8 rig."""
    import numpy as np
    import torch

    from pli_slam_tpu_torch.frontend.tracker import Tracker, TrackingState
    from pli_slam_tpu_torch.ops.kernels import hamming
    from pli_slam_tpu_torch.utils import synthetic
    from pli_slam_tpu_torch.utils.profile import (N_FRAMES_FISHEYE, fisheye_config, fisheye_rig, peek_ate,
                                                  slice6_frames, tracked_positions)

    t0 = time.perf_counter()
    cfg_vi, cam, frames = slice6_frames("fisheye_vi", dev)
    torch.cuda.synchronize()
    digest = synthetic.frame_digest(frames[0]["img_l"], frames[0]["img_r"])
    log(f"fisheye: rendered {len(frames)} KB8 pairs {cam.width}x{cam.height} (TUM-VI cam0, baseline "
        f"{cam.baseline:.3f} m) on the host in {time.perf_counter() - t0:.2f} s; first pair's SHA-256 {digest} (a CPU "
        f"build computes {FISHEYE0_SHA256}: {'equal' if digest == FISHEYE0_SHA256 else 'DIFFERENT'})")
    if digest != FISHEYE0_SHA256:
        raise AssertionError("the fisheye frames differ from the CPU's (tests/test_torch_fisheye.py holds the digest)")

    # 10a: the stereo sensor on the fused visual step
    cfg = fisheye_config(False)
    run = frames[:N_FRAMES_FISHEYE]
    tracker = Tracker(cam, cfg, dev, T_rl=fisheye_rig())
    tracker.streaming = True
    reset_counts()
    ms, init = [], None
    for i, fr in enumerate(run):
        f0 = time.perf_counter()
        tracker.process(fr["img_l"], fr["img_r"], fr["t"])
        dt = (time.perf_counter() - f0) * 1e3
        if init is None and tracker.state == TrackingState.OK:
            init = i  # this frame initialized the map on the host path
        elif init is not None:
            ms.append(dt)
    tracker.finalize()
    torch.cuda.synchronize()
    launches_a = hamming.launches
    count_small_kernels()
    if init is None:
        raise AssertionError("fisheye: the stereo map never initialized")
    est, gt = tracked_positions(tracker, run)
    ate = synthetic.ate_rmse(est, gt)
    n_fused = len(run) - init - 1
    ok_frames = _consumed_ok(tracker)
    assoc_ms, n_l, n_r, n_pairs = _fisheye_association_ms(cam, cfg, run[init], dev)
    log(f"fisheye 10a: stereo on the fused visual step, {len(run)} frames: the map initialized at frame {init} (the "
        f"reference: {REF_FISHEYE['init']}); frames {init + 1}-{len(run) - 1}: {_frame_times(ms)}; ATE {ate:.4f} m over "
        f"{len(est)} recorded frames (the reference: {REF_FISHEYE['ate']} m), {tracker.n_kf} keyframes (the reference: "
        f"{REF_FISHEYE['n_kf']}), ok frames {ok_frames}/{len(est)}, gated_match launches {launches_a} "
        f"({launches_a / max(n_fused, 1):.2f} per fused frame); the L<->R association {assoc_ms:.3f} ms a frame "
        f"({n_l} x {n_r} features, {n_pairs} pairs; CUDA events, mean of 20); {warmups(tracker)} [{smi}]")
    if abs(init - REF_FISHEYE["init"]) > INIT_MARGIN:
        raise AssertionError(f"fisheye: the map initialized at frame {init}, the reference at {REF_FISHEYE['init']}")
    if ok_frames < 0.9 * len(est) or not np.all(np.isfinite(est)):
        raise AssertionError(f"fisheye: {ok_frames}/{len(est)} recorded frames tracked")
    if not ate < FISHEYE_ATE_BOUND:
        raise AssertionError(f"fisheye: ATE {ate} m >= {FISHEYE_ATE_BOUND} m")
    if launches_a < 2 * n_fused:
        raise AssertionError(f"fisheye: gated_match launched {launches_a} times for {n_fused} fused frames")

    # 10b: stereo-inertial: host-path frames until the IMU initialization, then the fused VI step
    tracker = Tracker(cam, cfg_vi, dev, T_rl=fisheye_rig())
    tracker.streaming = True
    reset_counts()
    ms_host, ms_fused, launches_host = [], [], None
    map_init = imu_init = init_ms = ate_init = ate_pre = None
    for i, fr in enumerate(frames):
        fused = tracker.imu_ready and tracker.gravity_w is not None and tracker.state == TrackingState.OK
        if fused and launches_host is None:
            launches_host = hamming.launches
            count_small_kernels()
        f0 = time.perf_counter()
        tracker.process(fr["img_l"], fr["img_r"], fr["t"], imu=fr["imu"])
        dt = (time.perf_counter() - f0) * 1e3
        if map_init is None and tracker.state == TrackingState.OK:
            map_init = i
        elif tracker.imu_ready and imu_init is None:
            imu_init, init_ms = i, dt
            ate_init = peek_ate(tracker, frames)
        elif map_init is not None:
            (ms_fused if fused else ms_host).append(dt)
        if not tracker.imu_ready and map_init is not None and i >= map_init + 2:
            ate_pre = peek_ate(tracker, frames)  # outside the frame's time; the last one is the frame before the init
    tracker.finalize()
    torch.cuda.synchronize()
    launches_b = hamming.launches
    count_small_kernels()
    if imu_init is None:
        raise AssertionError(f"fisheye 10b: the IMU never initialized: {tracker.imu_init_log[-3:]}")
    rec = tracker.imu_init_log[-1]
    est, gt = tracked_positions(tracker, frames)
    ate_vi = synthetic.ate_rmse(est, gt)
    launches_fused = launches_b - launches_host
    n_host, n_fused_vi = imu_init - map_init, len(frames) - imu_init - 1
    log(f"fisheye 10b: stereo-inertial, {len(frames)} frames: the map initialized at frame {map_init}, the IMU at frame "
        f"{imu_init} (the reference: {REF_FISHEYE_VI['map_init']}, {REF_FISHEYE_VI['imu_init']}), that frame "
        f"{init_ms:.1f} ms, {rec['n_kf']} keyframes, gravity {_gravity_error_deg(tracker):.2f} deg from the truth; ATE "
        f"on the frame before it {ate_pre:.4f} m (the reference: {REF_FISHEYE_VI['ate_pre']} m), after its full "
        f"inertial BA {ate_init:.4f} m (the reference: {REF_FISHEYE_VI['ate_init']} m); {warmups(tracker)} [{smi}]")
    log(f"fisheye 10b: host-path frames: {_frame_times(ms_host)}, gated_match launches {launches_host} "
        f"({launches_host / max(n_host, 1):.2f} per tracked frame); fused stereo-inertial frames "
        f"{imu_init + 1}-{len(frames) - 1}: {_frame_times(ms_fused)}, launches {launches_fused} "
        f"({launches_fused / max(n_fused_vi, 1):.2f} per frame); ATE {ate_vi:.4f} m over {len(est)} recorded frames "
        f"(no reference figure: see REF_FISHEYE_VI), {tracker.n_kf} keyframes [{smi}]")
    if abs(imu_init - REF_FISHEYE_VI["imu_init"]) > INIT_MARGIN or not rec["accepted"]:
        raise AssertionError(f"fisheye 10b: the IMU initialized at frame {imu_init}: {rec}")
    if not ate_pre < FISHEYE_VI_ATE_PRE_BOUND or not (np.all(np.isfinite(est)) and ate_vi < FISHEYE_VI_ATE_BOUND):
        raise AssertionError(f"fisheye 10b: ATE {ate_pre} m before the IMU initialization, {ate_vi} m over the run")
    if launches_host < 2 * n_host or launches_fused < 2 * n_fused_vi:
        raise AssertionError(f"fisheye 10b: gated_match launched {launches_host} + {launches_fused} times for "
                             f"{n_host} host-path and {n_fused_vi} fused frames")
    return (launches_a, max(n_fused, 1)), (launches_b, len(frames) - map_init - 1), assoc_ms


def phase_mono_vi(dev, smi):
    """Phase 11 (see the module docstring): mono-inertial through
    `System.track_monocular(..., imu_batch=)`."""
    import numpy as np
    import torch

    from pli_slam_tpu_torch.frontend.tracker import TrackingState
    from pli_slam_tpu_torch.ops.kernels import hamming
    from pli_slam_tpu_torch.system import System
    from pli_slam_tpu_torch.utils import trajectory as tio
    from pli_slam_tpu_torch.utils.profile import path_ratio, peek_ate, slice6_frames, tracked_positions

    t0 = time.perf_counter()
    cfg, cam, frames = slice6_frames("mono_vi", dev)
    torch.cuda.synchronize()
    log(f"mono-inertial: rendered {len(frames)} frames {cam.width}x{cam.height} with {len(frames[0]['imu_gyro'])} IMU "
        f"samples each in {time.perf_counter() - t0:.2f} s")
    sysm = System(cam, cfg, device=dev)
    tracker = sysm.tracker
    held, replays, traced = {}, [], []
    hold_calls(tracker, {"_try_imu_init": (lambda tr: True, lambda tr, ret: tr.imu_ready)}, held)
    reset_counts()
    ms, states = [], []
    mono_init = imu_init = init_ms = ate_init = ate_pre = None
    launches_init = None
    for i, fr in enumerate(frames):
        res = []
        with check_replays(INIT_STAGES, replays):
            if imu_init_due(tracker, fr["t"]):  # the frame that may initialize the IMU: its host launches
                wall, _, n, ng = _traced(dev, lambda: res.append(sysm.track_monocular(fr["img_l"], fr["t"],
                                                                                      imu_batch=fr["imu"])))
                dt = wall * 1e3
                traced.append((i, n, ng, dt))
            else:
                f0 = time.perf_counter()
                res.append(sysm.track_monocular(fr["img_l"], fr["t"], imu_batch=fr["imu"]))
                dt = (time.perf_counter() - f0) * 1e3
        info = res[0]
        states.append(info["state"])
        if mono_init is None and info["state"] == TrackingState.OK:
            mono_init = i
        elif tracker.imu_ready and imu_init is None:
            imu_init, init_ms, launches_init = i, dt, hamming.launches
            ate_init = peek_ate(tracker, frames, with_scale=True)
        elif mono_init is not None:
            ms.append(dt)
        if not tracker.imu_ready and mono_init is not None and i >= mono_init + 2:
            ate_pre = peek_ate(tracker, frames, with_scale=True)
    torch.cuda.synchronize()
    launches = hamming.launches
    count_small_kernels()
    sysm.shutdown()
    if mono_init is None or imu_init is None:
        raise AssertionError(f"mono-inertial: initialized at frame {mono_init}, the IMU at {imu_init}: "
                             f"{tracker.imu_init_log[-3:]}")
    rec = tracker.imu_init_log[-1]
    est, gt = tracked_positions(tracker, frames)
    ate_sim3, ate_se3 = tio.ate_rmse(est, gt, with_scale=True), tio.ate_rmse(est, gt)
    ratio = path_ratio(est, gt)
    n_ok = sum(s == TrackingState.OK for s in states)
    n_tracked = imu_init - mono_init
    log(f"mono-inertial: System.track_monocular(imu_batch=) over {len(frames)} frames: the map initialized at frame "
        f"{mono_init}, the IMU at frame {imu_init} (the reference: {REF_MONO_VI['mono_init']}, "
        f"{REF_MONO_VI['imu_init']}), that frame {init_ms:.1f} ms; its record: scale {rec.get('scale')} (the "
        f"reference: {REF_MONO_VI['scale']}), gravity {_gravity_error_deg(tracker):.2f} deg from the truth, "
        f"{rec['n_kf']} keyframes [{smi}]")
    log(f"mono-inertial: frames after the map's initialization: {_frame_times(ms)}; Sim(3) ATE on the frame before the "
        f"IMU initialization {ate_pre:.4f} m (the reference: {REF_MONO_VI['ate_pre_sim3']} m), after its full inertial "
        f"BA {ate_init:.4f} m (the reference: {REF_MONO_VI['ate_init_sim3']} m), over the run Sim(3) "
        f"{ate_sim3:.4f} m (the reference: {REF_MONO_VI['ate_sim3']} m) and SE(3) {ate_se3:.4f} m; path-length ratio "
        f"of the last 20 frames without alignment {ratio:.4f} (the reference: {REF_MONO_VI['ratio']}); ok frames "
        f"{n_ok}/{len(frames)} (states after the IMU initialization {states[imu_init + 1:]}); gated_match launches "
        f"{launches} ({launches_init} up to the IMU initialization) [{smi}]")
    if abs(mono_init - REF_MONO_VI["mono_init"]) > MONO_INIT_MARGIN:
        raise AssertionError(f"mono-inertial: the map initialized at frame {mono_init}")
    if abs(imu_init - REF_MONO_VI["imu_init"]) > INIT_MARGIN or not rec["accepted"]:
        raise AssertionError(f"mono-inertial: the IMU initialized at frame {imu_init}: {rec}")
    if not ate_pre < MONO_VI_ATE_PRE_BOUND or not np.all(np.isfinite(est)) or not 0.0 < rec["scale"] < np.inf:
        raise AssertionError(f"mono-inertial: Sim(3) ATE {ate_pre} m before the IMU initialization, scale {rec['scale']}")
    if launches_init < 2 * n_tracked:
        raise AssertionError(f"mono-inertial: gated_match launched {launches_init} times for {n_tracked} frames")
    init_paths("mono-inertial", dev, tracker, held, replays, traced, imu_init, smi)
    return launches, len(frames) - mono_init - 1


def phase_rgbd_vi(dev, smi):
    """Phase 12 (see the module docstring): RGB-D-inertial through
    `Tracker.process_rgbd(..., imu=)`, every frame on the host path."""
    import numpy as np
    import torch

    from pli_slam_tpu_torch.frontend.tracker import Tracker, TrackingState
    from pli_slam_tpu_torch.ops.kernels import hamming
    from pli_slam_tpu_torch.utils import synthetic
    from pli_slam_tpu_torch.utils.profile import peek_ate, slice6_frames, tracked_positions

    t0 = time.perf_counter()
    cfg, cam, frames = slice6_frames("rgbd_vi", dev)
    torch.cuda.synchronize()
    log(f"rgbd-inertial: rendered {len(frames)} frames {cam.width}x{cam.height} with depth and "
        f"{len(frames[0]['imu_gyro'])} IMU samples each in {time.perf_counter() - t0:.2f} s")
    tracker = Tracker(cam, cfg, dev)
    held, traced, init_replays = {}, [], []
    hold_calls(tracker, {"_try_imu_init": (lambda tr: True, lambda tr, ret: tr.imu_ready)}, held)
    reset_counts()
    ms_before, ms_after, init_frame, ate_pre, replays = [], [], None, None, []
    for i, fr in enumerate(frames):
        f0 = time.perf_counter()
        s0 = sum(sec for _, _, sec in replays + init_replays)
        # each "vi_ba" replay, and each new stage's call, also run eagerly, its time taken out
        with check_replays(("vi_ba",), replays), check_replays(INIT_STAGES, init_replays):
            if imu_init_due(tracker, fr["t"]):  # the frame that may initialize the IMU: its host launches
                wall, _, n, ng = _traced(dev, lambda: tracker.process_rgbd(fr["img_l"], fr["depth"], fr["t"],
                                                                           imu=fr["imu"]))
                traced.append((i, n, ng, wall * 1e3))
            else:
                tracker.process_rgbd(fr["img_l"], fr["depth"], fr["t"], imu=fr["imu"])
        dt = (time.perf_counter() - f0 - sum(sec for _, _, sec in replays + init_replays) + s0) * 1e3
        if traced and traced[-1][0] == i:  # the trace's wall time, without its export
            dt = traced[-1][3]
        if tracker.imu_ready and init_frame is None:
            init_frame, init_ms = i, dt
            v_err = float(np.linalg.norm(tracker.v_w.cpu().numpy() - fr["v_w"]))
            ate_init = peek_ate(tracker, frames)
        elif i > 0:
            (ms_after if init_frame is not None else ms_before).append(dt)
        if not tracker.imu_ready and i >= 2:
            ate_pre = peek_ate(tracker, frames)
    tracker.finalize()
    torch.cuda.synchronize()
    launches = hamming.launches
    count_small_kernels()
    if init_frame is None:
        raise AssertionError(f"rgbd-inertial: the IMU never initialized: {tracker.imu_init_log[-3:]}")
    rec = tracker.imu_init_log[-1]
    g_angle = _gravity_error_deg(tracker)
    est, gt = tracked_positions(tracker, frames)
    ate = synthetic.ate_rmse(est, gt)
    ok_frames = sum(s["state"] == TrackingState.OK for s in tracker.stats)
    log(f"rgbd-inertial: Tracker.process_rgbd(imu=) over {len(frames)} frames (all on the host path): IMU init at frame "
        f"{init_frame} (the reference: {REF_RGBD_VI['imu_init']}), {rec['n_kf']} keyframes, that frame {init_ms:.1f} ms, "
        f"the initialization {rec['wall_ms']:.1f} ms of it; gravity {g_angle:.2f} deg from the truth; velocity "
        f"{v_err:.3f} m/s from the truth; ATE of frames 0-{init_frame - 1} {ate_pre:.4f} m "
        f"(the reference: {REF_RGBD_VI['ate_pre']} m), after the initialization's full inertial BA {ate_init:.4f} m "
        f"(the reference: {REF_RGBD_VI['ate_init']} m); bg {np.round(rec['bg'], 4).tolist()}, ba "
        f"{np.round(rec['ba'], 4).tolist()} [{smi}]")
    log(f"rgbd-inertial: frames 1-{init_frame - 1}: {_frame_times(ms_before)}; frames {init_frame + 1}-"
        f"{len(frames) - 1}: {_frame_times(ms_after)}; ATE {ate:.4f} m (the reference: {REF_RGBD_VI['ate']} m), "
        f"{tracker.n_kf} keyframes, ok frames {ok_frames}/{len(frames)}, gated_match launches {launches} "
        f"({launches / (len(frames) - 1):.2f} per tracked frame); each of the {len(replays)} visual-inertial BA "
        f"replays (the IMU initialization's, the keyframes' windows, the post-closure chunks) bit-identical to "
        f"the stage run eagerly on its inputs: {all(bad is None for _, bad, _ in replays)} [{smi}]")
    if tracker.cuda_graphs and (not replays or any(bad is not None for _, bad, _ in replays)):
        raise AssertionError(f"rgbd-inertial: a vi_ba replay differs from the stage run eagerly (stage, first "
                             f"output leaf that differs): {replays}")
    if abs(init_frame - REF_RGBD_VI["imu_init"]) > INIT_MARGIN or not rec["accepted"]:
        raise AssertionError(f"rgbd-inertial: the IMU initialized at frame {init_frame}: {rec}")
    if not ate_pre < RGBD_VI_ATE_PRE_BOUND or not (np.all(np.isfinite(est)) and ate < RGBD_VI_ATE_BOUND):
        raise AssertionError(f"rgbd-inertial: ATE {ate_pre} m before the IMU initialization, {ate} m over the run")
    if ok_frames < 0.9 * len(frames):
        raise AssertionError(f"rgbd-inertial: only {ok_frames}/{len(frames)} frames tracked")
    if launches < 2 * (len(frames) - 1):
        raise AssertionError(f"rgbd-inertial: gated_match launched {launches} times for {len(frames) - 1} frames")
    init_paths("rgbd-inertial", dev, tracker, held, init_replays, traced, init_frame, smi)
    return launches, len(frames) - 1


# ---------------------------------------------------------------------------
# Phase 13: distribution on torch.distributed
# ---------------------------------------------------------------------------

DIST_WORLD = 4
# 4 ranks against one process on the noisy problem (`production.with_point_noise`): ~5x the H100's reading (R
# 1.07e-6, t 7.33e-6 m, relative cost 0); a reduction that loses one shard moves them by 1.66e-4, 1.33e-3 m and
# 0.25, one that averages moves the cost by 0.75
DIST_R_TOL, DIST_T_TOL, DIST_COST_RTOL = 5e-6, 3e-5, 1e-5


def _pose_cost_diff(res, R, t, cost):
    """(max |dR|, max |dt|, relative cost difference) of a BA result against poses and a cost."""
    import numpy as np

    return (float(np.abs(res.R.cpu().numpy() - R).max()), float(np.abs(res.t.cpu().numpy() - t).max()),
            abs(float(res.cost) - cost) / abs(float(res.cost)))


def phase_distribution(dev, smi):
    """13a-13c (see the module docstring). One group of 4 ranks serves the
    dry runs of every world size (13c's rows); 13a reads its 1- and 4-rank
    results."""
    import tempfile

    import torch

    from pli_slam_tpu_torch.scripts import bench_scaling
    from pli_slam_tpu_torch.solve import ba
    from pli_slam_tpu_torch.utils import production
    from pli_slam_tpu_torch.utils.config import OptimizerConfig

    t0 = time.perf_counter()
    scaling = bench_scaling.scaling_rows([1, 2, DIST_WORLD], "gloo", dev, timeout=400.0)
    wall = time.perf_counter() - t0
    one, out = scaling[0][1], scaling[-1][1]
    cam, prob_host, _ = production.build_production_ba_problem(DIST_WORLD)
    prob = _to(prob_host, dev)
    cfg = OptimizerConfig(local_ba_window=32)
    ba.solve_ba(cam, prob, cfg, iters=0)  # warm-up
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    single = ba.solve_ba(cam, prob, cfg, iters=6)
    torch.cuda.synchronize()
    single_ms = (time.perf_counter() - t1) * 1e3
    noisy = _to(production.with_point_noise(prob_host), dev)
    ref = ba.solve_ba(cam, noisy, cfg, iters=6)
    d1 = _pose_cost_diff(single, one["ba_R"], one["ba_t"], one["cost1"])
    d1n = _pose_cost_diff(ref, one["noisy_R"], one["noisy_t"], one["noisy_cost"])
    ms = out["ms_max"]
    log(f"distribution 13a: dryrun_multichip({DIST_WORLD}, gloo, {dev}) at production shapes (W=32, P=16384, L=1024, "
        f"{out['n_obs']} observation rows; PGO 256 nodes / {out['n_edges']} edges): Schur BA cost {out['cost0']:.4f} "
        f"-> {out['cost1']:.6f} in {ms['ba']:.1f} ms (6 iterations), whole-map BA {out['c_init']:.1f} -> "
        f"{out['gcost']:.4f} in {ms['gba']:.1f} ms (12), se3 PGO mean t-error {out['t_err0']:.4f} -> "
        f"{out['t_err1']:.2e} m in {ms['pgo']:.1f} ms (12; slowest rank, synchronised); the {DIST_WORLD} ranks' "
        f"poses bit-identical; the 1-rank group against the in-process solve_ba on the card ({single_ms:.1f} ms "
        f"warm, cost {float(single.cost):.6f}): max |dR|, |dt| and relative cost {d1} on the dry run's problem, "
        f"{d1n} on the noisy one (must be 0) [{smi}]")
    if any(d1) or any(d1n):
        raise AssertionError(f"distribution: the 1-rank group differs from the in-process solve_ba by {d1}, {d1n}")

    # The dry run's problem is exact, so any solver that converges lands on the truth, a wrong reduction too.
    # With observation noise the optimum depends on every observation: 4 ranks against the in-process solve,
    # and beside it the answer of a reduction that loses one shard (shard 3's observations masked).
    lost = dataclasses.replace(noisy, po_mask=noisy.po_mask & (noisy.po_pt % DIST_WORLD != DIST_WORLD - 1),
                               lo_mask=noisy.lo_mask & (noisy.lo_ln % DIST_WORLD != DIST_WORLD - 1))
    d4 = _pose_cost_diff(ref, out["noisy_R"], out["noisy_t"], out["noisy_cost"])
    lres = ba.solve_ba(cam, lost, cfg, iters=6)
    dl = _pose_cost_diff(ref, lres.R.cpu().numpy(), lres.t.cpu().numpy(), float(lres.cost))
    tol = (DIST_R_TOL, DIST_T_TOL, DIST_COST_RTOL)
    log(f"distribution 13a: {production.NOISE_PX} px of noise on the point observations, {DIST_WORLD} ranks against "
        f"the in-process solve_ba (cost {float(ref.cost):.4f}): max |dR| {d4[0]:.3e}, max |dt| {d4[1]:.3e} m, "
        f"relative cost {d4[2]:.3e} (tolerances {tol}); one shard's observations lost: {dl[0]:.3e}, {dl[1]:.3e} m, "
        f"{dl[2]:.3e} [{smi}]")
    if not all(d <= x for d, x in zip(d4, tol)):
        raise AssertionError(f"distribution 13a: {DIST_WORLD}-rank BA off the in-process solve by {d4} (tol {tol})")
    if not all(d > 10 * x for d, x in zip(dl, tol)):
        raise AssertionError(f"distribution 13a: the tolerances {tol} would not see a lost shard ({dl})")

    t0 = time.perf_counter()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="rdv_", dir=os.path.join(ROOT, "build")) as tmp:
        env = dict(os.environ, PYTHONPATH=ROOT)
        cmd = [sys.executable, "-m", "pli_slam_tpu_torch.scripts.run_multihost_ba", "--init-method",
               f"file://{os.path.join(tmp, 'rdv')}", "--world-size", "2", "--backend", "gloo", "--timeout", "240"]
        procs = [subprocess.Popen(cmd + ["--rank", str(r)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True, cwd=ROOT, env=env) for r in range(2)]
        try:
            outs = [p.communicate(timeout=300)[0] for p in procs]
        finally:
            for p in procs:
                p.kill()
                p.wait()
    costs = []
    for r, (p, text) in enumerate(zip(procs, outs)):
        line = [ln for ln in text.splitlines() if ln.startswith(f"MULTIHOST rank={r} world=2 cost=")]
        if p.returncode != 0 or not line:
            raise AssertionError(f"distribution 13b: rank {r} exited {p.returncode}:\n{text[-3000:]}")
        costs.append(float(line[0].split("cost=")[1]))
    log(f"distribution 13b: two run_multihost_ba processes (gloo over file://, both on {dev}): costs {costs} in "
        f"{time.perf_counter() - t0:.1f} s [{smi}]")
    if not (costs[0] == costs[1] and costs[0] < 1.0):
        raise AssertionError(f"distribution 13b: costs {costs} (must be equal and below 1.0)")

    log(f"distribution 13c: bench_scaling over world sizes 1/2/4 (gloo; {wall:.1f} s for the one group of 4 ranks, "
        f"size n on ranks 0..n-1): the ranks share this one card's SMs, so these rows measure the per-shard work and "
        f"gloo's host-staged all-reduce, not multi-card scaling [{smi}]")
    for row, _ in scaling:
        log(f"distribution 13c: {bench_scaling.format_row(row)} [{smi}]")
    return scaling


# ---------------------------------------------------------------------------
# Phase 14: bench.py's flagship path (stereo-inertial, loop closing on)
# ---------------------------------------------------------------------------

# 14a: the largest turn, in degrees, of any keyframe's world z axis in its camera frame (R_cw e_z, the axis the
# 4-DoF essential graph keeps) across the planted closure's correction: ~5x the H100's reading (3.815e-5)
FLAGSHIP_ZAXIS_DEG = 2e-4
# 14a: the largest difference, in degrees, between a keyframe's gravity turn across the correction and the turn
# that its own rotation about world z gives (ROADMAP queue 3 B13; `utils.profile.b13_gravity_turn_deg`): ~5x the
# H100's reading (3.036e-5 on a 0.2606-degree turn)
FLAGSHIP_B13_MARGIN_DEG = 1.5e-4
N_BENCH_FLAGSHIP = 76  # 14b: the IMU initializes at frame 69-70 on the card (the reference on its CPU: 72-74)
N_BENCH_VISUAL = 20


def bench_line_keys(path: str) -> tuple[list[str], list[str]]:
    """The keys of the JSON line a bench.py-style `main` prints, read from
    its source with `ast` (the file is not imported): (top-level keys, keys
    of "extra")."""
    import ast

    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict) and any(isinstance(k, ast.Constant) and k.value == "extra" for k in node.keys):
            extra = node.values[[k.value for k in node.keys].index("extra")]
            return [k.value for k in node.keys], [k.value for k in extra.keys]
    raise ValueError(f"no result line with an 'extra' dict in {path}")


def phase_flagship_closure(dev, smi, run):
    """14a (see the module docstring): the inertial loop closure on phase 6a's frames with their IMU."""
    import numpy as np

    from pli_slam_tpu_torch.ops.kernels import hamming
    from pli_slam_tpu_torch.utils.profile import flagship_config, inertial_loop_run

    _, traj, frames = run
    cfg, cam = flagship_config(), run[0].cam
    reset_counts()
    r = inertial_loop_run(cfg, cam, traj, frames, dev)
    launches = hamming.launches
    count_small_kernels()
    tracker, init, planted, n_frames = r["tracker"], r["init"], r["planted"], r["n_frames"]
    if not init:
        raise AssertionError(f"flagship 14a: the IMU never initialized in {n_frames} frames: "
                             f"{tracker.imu_init_log[-3:]}")
    n_host = init["frame"] + 1
    ok_frames = _consumed_ok(tracker, n_host)
    pct = lambda v, q: float(np.percentile(v, q))  # noqa: E731
    rec = init["record"]
    log(f"flagship 14a: IMU init at frame {init['frame']} ({rec['n_kf']} keyframes, accepted {rec['accepted']}), "
        f"that frame {init['ms']:.1f} ms; ATE of frames 0-{init['frame']} {init['ate']:.4f} m; host-path frames: "
        f"mean {np.mean(r['ms_host']):.2f} ms, p50 {pct(r['ms_host'], 50):.2f} ms; fused stereo-inertial frames: "
        f"mean {np.mean(r['ms_fused']):.2f} ms, p99 {pct(r['ms_fused'], 99):.2f} ms; {warmups(r['tracker'])} [{smi}]")
    log(f"flagship 14a: loops closed by the run {r['natural']} (frames with a verification: frame, ms, closed, "
        f"imu_ready {r['loop_frames']}); Tracker construction ran the closure's warm-up in "
        f"{tracker.loop_warmup_ms} ms [{smi}]")
    if planted is not None:
        log(f"flagship 14a: planted closure at keyframe {planted['kf_cur']} of {tracker.n_kf} (min_kf_gap "
            f"{cfg.loop.min_kf_gap}; candidates (slot, ground-truth cost) {planted['cands']}), "
            f"imu_ready {planted['imu_ready']}, closed {planted['closed']}, verification + 4-DoF PGO + queueing "
            f"{planted['ms']} ms; largest keyframe position error against the truth {planted['kf_before']:.4f} m "
            f"before, {planted['kf_after']:.4f} m after the correction; largest turn of a keyframe's world z axis "
            f"{planted['z_deg']:.3e} deg (bound {FLAGSHIP_ZAXIS_DEG}), of its gravity direction "
            f"{planted['gravity_deg']:.3e} deg (gravity {planted['tilt_deg']:.3f} deg off the world -z axis; the "
            f"keyframes' rotations about world z give up to {planted['gravity_pred_deg']:.3e} deg, ROADMAP queue 3 "
            f"B13; largest difference {planted['gravity_excess_deg']:.3e} deg, bound {FLAGSHIP_B13_MARGIN_DEG}); "
            f"queued {planted['queued']} [{smi}]")
    log(f"flagship 14a: {len(r['t_fiba'])} fiba chunks run, ms each {[round(t, 2) for t in r['t_fiba']]}, largest "
        f"keyframe position error after each {[round(e, 4) for e in r['kf_errs']]} m; queue left "
        f"{len(tracker._deferred_ba)}; ATE {r['ate']:.4f} m over {n_frames} frames, n_kf {tracker.n_kf}, ok frames "
        f"{ok_frames}/{n_frames}, gated_match launches {launches} ({launches / (n_frames - 1):.2f} per tracked "
        f"frame) [{smi}]")
    if not rec["accepted"] or not init["ate"] < 0.10:
        raise AssertionError(f"flagship 14a: at the IMU initialization {rec}, ATE {init['ate']} m")
    closed_after_init = any(c and ready for _, _, c, ready in r["loop_frames"])
    if planted is not None:
        if not (planted["closed"] and planted["imu_ready"]):
            raise AssertionError(f"flagship 14a: the planted closure did not verify with the IMU initialized: {planted}")
        if not planted["queued"] or set(planted["queued"]) != {"fiba"}:
            raise AssertionError(f"flagship 14a: the closure queued {planted['queued']}, not the fiba sweep")
        if not planted["z_deg"] <= FLAGSHIP_ZAXIS_DEG:
            raise AssertionError(f"flagship 14a: the 4-DoF correction turned a keyframe's world z axis by "
                                 f"{planted['z_deg']} deg")
        if not planted["gravity_excess_deg"] <= FLAGSHIP_B13_MARGIN_DEG:
            raise AssertionError(f"flagship 14a: a keyframe's gravity direction turned {planted['gravity_excess_deg']} "
                                 f"deg off what its rotation about world z gives (largest turn "
                                 f"{planted['gravity_deg']} deg, predicted {planted['gravity_pred_deg']} deg)")
    elif not closed_after_init:
        raise AssertionError(f"flagship 14a: the run's closures {r['loop_frames']} came before the IMU initialization")
    if tracker._deferred_ba or not r["t_fiba"]:
        raise AssertionError(f"flagship 14a: {len(r['t_fiba'])} fiba chunks run, {len(tracker._deferred_ba)} left")
    if not np.all(np.isfinite(r["est"])) or r["est"].shape[0] != n_frames:
        raise AssertionError(f"flagship 14a: trajectory {r['est'].shape}, finite {np.all(np.isfinite(r['est']))}")
    if ok_frames < 0.9 * n_frames:
        raise AssertionError(f"flagship 14a: only {ok_frames}/{n_frames} frames tracked")
    if launches < 2 * (n_frames - 1):
        raise AssertionError(f"flagship 14a: gated_match launched {launches} times for {n_frames - 1} tracked frames")
    return launches, n_frames


def phase_bench(dev, smi, run, room):
    """14b (see the module docstring): scripts/bench.py's two runs in this process."""
    import numpy as np

    from pli_slam_tpu_torch.ops.kernels import hamming
    from pli_slam_tpu_torch.scripts import bench

    reset_counts()
    t0 = time.perf_counter()
    flag = bench.run_flagship(N_BENCH_FLAGSHIP, device=dev, frames=run[2])
    vis = bench.run_visual(N_BENCH_VISUAL, device=dev, frames=room)
    wall = time.perf_counter() - t0
    launches = hamming.launches
    count_small_kernels()
    text = json.dumps(bench.result_line(flag, vis))
    line = json.loads(text)
    keys, extra = bench_line_keys(os.path.join(ROOT, "bench.py"))
    log(f"bench 14b: scripts/bench.py at BENCH_FRAMES={N_BENCH_FLAGSHIP}, BENCH_FRAMES_VISUAL={N_BENCH_VISUAL} "
        f"({wall:.1f} s, frames rendered once for phase 6a): {text} [{smi}]")
    n_frames = N_BENCH_FLAGSHIP + N_BENCH_VISUAL
    log(f"bench 14b: gated_match launches {launches} ({launches / (n_frames - 2):.2f} per tracked frame); the "
        f"flagship's {warmups(flag['tracker'])}; the visual run's {warmups(vis['tracker'])} [{smi}]")
    if sorted(line) != sorted(keys) or sorted(line["extra"]) != sorted(extra):
        raise AssertionError(f"bench 14b: the line's keys {sorted(line)} / {sorted(line['extra'])} are not bench.py's "
                             f"{sorted(keys)} / {sorted(extra)}")
    if not line["extra"]["imu_ready"]:
        raise AssertionError("bench 14b: the flagship run never initialized the IMU")
    times = [line["value"], line["vs_baseline"]] + [line["extra"][k] for k in ("p99_ms", "p50_ms", "worst_ms",
                                                                                 "visual_fps")]
    ates = [line["extra"]["ate_m_synthetic"], line["extra"]["visual_ate_m"]]
    if not np.all(np.isfinite(times + ates)) or min(times) <= 0:
        raise AssertionError(f"bench 14b: times {times}, ATEs {ates}")
    if launches < 2 * (n_frames - 2):
        raise AssertionError(f"bench 14b: gated_match launched {launches} times for {n_frames - 2} tracked frames")
    return launches, n_frames


# ---------------------------------------------------------------------------
# Phase 15: the fused steps and the host-path stages as CUDA graphs against the same run eagerly
# ---------------------------------------------------------------------------


N_GRAPH_TRACE = 4  # each phase-15 run's last frames, traced (CUDA activity only): launches and busy share
# phase 15's eager runs are cut to these depths (graphs run the whole sequences): the eager frames cost
# ~1-2 s each, and the script keeps its time (20 / 40 until the checks and warm-ups of the map
# initializations' stages came). 34 frames of phase 5 pass its IMU initialization (frame 30).
N_EAGER_VISUAL, N_EAGER_VI = 12, 34
HOST_TRACE_FROM, HOST_TRACE_MAX = 12, 8  # phase 5's host-path frames traced one by one from frame 12 until a
# keyframe and a tracking-only frame are both among them
HOST_LAUNCH_LIMIT = 2000  # host kernel launches a host-path frame under graphs: more means a stage ran eagerly
RARE_STAGES = ("reloc_match", "reloc_pnp", "reloc_track", "reloc_pick", "loop_match", "loop_verify", "loop_correct",
               "vi_ba", "gba")
STORES = ("pstore", "lstore", "kstore", "bow_db")


def _traced(dev, fn) -> tuple[float, float, int, int]:
    """`fn()` inside a CUDA-activity trace, the device synchronised after it:
    (wall s, device busy us, host kernel launches, host graph launches)."""
    import torch

    torch.cuda.synchronize(dev)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    return (wall, *_trace_counts(prof))


def _trace_counts(prof) -> tuple[float, int, int]:
    """(device busy us, host kernel launches, host graph launches) of a
    CUDA-activity trace, read from the profiler's results as
    `FrameTrace._read` reads them: the union of the device's kernels,
    copies and memsets, the host's `cudaLaunchKernel*` and
    `cudaGraphLaunch` calls (profile.trace_busy's figures, without the
    export)."""
    from torch.autograd import DeviceType

    from pli_slam_tpu_torch.utils.profile import union_us

    busy, launches, graph_launches = [], 0, 0
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CPU:
            launches += name.startswith("cudaLaunchKernel")
            graph_launches += name == "cudaGraphLaunch"
        elif not e.is_user_annotation():
            busy.append((e.start_ns() / 1e3, e.duration_ns() / 1e3))
    return union_us(busy), launches, graph_launches


class FrameTrace:
    """CPU and CUDA activity traces of frames: `with trace.frame(k):` traces
    frame k. After the block, `frames` is [(k, host kernel launches, host
    graph launches, ms)], the launches counted from the host's CUDA runtime
    calls inside the frame's mark, the ms up to the device synchronised
    after it (the synchronisation outside the mark), and `calls` maps k to
    the frame's CUDA runtime calls, each (name, the kind of the copy it
    issued, e.g. "Memcpy DtoH (Device -> Pinned)", or None). Reading a trace
    is its cost (seconds): by default one trace spans every frame; with
    `per_frame` each frame has its own, and only the frames passed to
    `keep(k)` right after their block are read, then."""

    def __init__(self, dev, per_frame: bool = False):
        self.dev, self.per_frame, self.frames, self.calls, self._ms = dev, per_frame, [], {}, {}
        self.read_s = 0.0  # the traces' export and reading
        self._last = None

    @staticmethod
    def _profiler():
        import torch

        acts = torch.profiler.ProfilerActivity
        return torch.profiler.profile(activities=[acts.CPU, acts.CUDA])

    def __enter__(self):
        if not self.per_frame:
            self._prof = self._profiler()
            self._prof.__enter__()
        return self

    @contextlib.contextmanager
    def frame(self, k: int):
        import torch

        self._last = None
        prof = self._profiler() if self.per_frame else contextlib.nullcontext()
        t0 = time.perf_counter()
        with prof:
            with torch.profiler.record_function(f"chip_smoke frame {k}"):
                yield
        torch.cuda.synchronize(self.dev)
        self._ms[k] = (time.perf_counter() - t0) * 1e3
        if self.per_frame:
            self._last = (k, prof)

    def keep(self, k: int) -> None:
        """Read frame k's trace now: a later frame's profiler clears what an
        earlier one recorded of the CUDA runtime."""
        if self._last is not None and self._last[0] == k:
            self._count(self._read(self._last[1]))
            self._last = None

    @staticmethod
    def _category(e) -> str | None:
        """The chrome export's `cat` of a profiler event that `_count` reads:
        a frame's mark (on the host), a CUDA runtime call (on the host), a
        copy (on the device); None for the rest."""
        from torch.autograd import DeviceType

        name, host = e.name(), e.device_type() == DeviceType.CPU
        if host and name.startswith("chip_smoke frame "):
            return "user_annotation"
        if host and name.startswith("cuda"):
            return "cuda_runtime"
        if not host and name.startswith("Memcpy"):
            return "gpu_memcpy"
        return None

    def _read(self, prof) -> list:
        """The trace's frame marks, CUDA runtime calls and copies as its
        chrome export holds them (`cat`, `name`, `ts` and `dur` in us, the
        correlation id, which ties a copy's runtime call to its device
        record), read from the profiler's results: exporting and parsing the
        whole trace (every graph kernel a record) took ~85 s for phase 8's
        40 frames."""
        t0 = time.perf_counter()
        events = []
        for e in prof.profiler.kineto_results.events():
            cat = self._category(e)
            if cat is not None:
                events.append({"ph": "X", "cat": cat, "name": e.name(), "ts": e.start_ns() / 1e3,
                               "dur": e.duration_ns() / 1e3, "args": {"correlation": e.correlation_id()}})
        self.read_s += time.perf_counter() - t0
        return events

    def __exit__(self, *exc):
        t0 = time.perf_counter()
        if not self.per_frame:
            self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        if not self.per_frame:
            self._count(self._read(self._prof))
        self.export_s = time.perf_counter() - t0 + (self.read_s if self.per_frame else 0.0)  # stop, export, reading
        return False

    def _count(self, events) -> None:
        marks = {int(e["name"].rsplit(" ", 1)[1]): (e["ts"], e["ts"] + e["dur"]) for e in events
                 if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                 and e.get("name", "").startswith("chip_smoke frame ")}
        copies = {e.get("args", {}).get("correlation"): e.get("name", "") for e in events
                  if e.get("cat") == "gpu_memcpy"}
        calls = [(e["ts"], e.get("name", ""), copies.get(e.get("args", {}).get("correlation")))
                 for e in events if e.get("cat") == "cuda_runtime"]
        for k, (a, b) in sorted(marks.items()):
            inside = [(n, kind) for ts, n, kind in calls if a <= ts <= b]
            self.calls[k] = inside
            self.frames.append((k, sum(1 for n, _ in inside if n.startswith("cudaLaunchKernel")),
                                sum(1 for n, _ in inside if n == "cudaGraphLaunch"), self._ms[k]))


HOST_WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


def one_read_faults(calls: list) -> list[str]:
    """What breaks a streaming fused frame's one read in its CUDA runtime calls
    (`FrameTrace.calls[k]`): it makes exactly one graph launch; it copies
    from the device to the host only the stats vector (one non-blocking copy
    into pinned memory) and copies nothing synchronously; its only wait is
    the one on the previous frame's stats event (at most one
    cudaEventSynchronize, none if that frame had finished); it synchronises
    no stream and not the device."""
    names = [n for n, _ in calls]
    faults = []
    if names.count("cudaGraphLaunch") != 1:
        faults.append(f"{names.count('cudaGraphLaunch')} graph launches")
    waits = {w: names.count(w) for w in HOST_WAITS if names.count(w)}
    if waits.get("cudaStreamSynchronize") or waits.get("cudaDeviceSynchronize") or waits.get(
            "cudaEventSynchronize", 0) > 1:
        faults.append(f"waits {waits}")
    d2h = [(n, kind) for n, kind in calls if kind and "DtoH" in kind]
    if len(d2h) > 1 or any(not n.startswith("cudaMemcpyAsync") or "Pinned" not in kind for n, kind in d2h):
        faults.append(f"device-to-host copies {d2h}")
    sync_copies = [n for n in names if n.startswith("cudaMemcpy") and "Async" not in n]
    if sync_copies:
        faults.append(f"synchronous copies {sync_copies}")
    return faults


def _captures(tracker) -> dict:
    """Each captured program's captures: the fused step's, and every stage's by name."""
    fused = tracker._fused_step()
    return {"fused step": fused.captures if fused is not None else 0,
            **{p.name: p.captures for p in tracker.stage_programs()}}


N_ONE_READ = 4  # each phase-15 graph run's fused frames before the last N_GRAPH_TRACE: their runtime calls checked


def phase_graphs_run(dev, cam, cfg, frames, cuda_graphs: bool, snapshot_after: int, host_trace: bool = False) -> dict:
    """One run of phase 15 over `frames`: every frame's (R, t) and every fused
    frame's stats vector recorded, the frames' records and the stores copied
    after `snapshot_after` frames (the kernels' launches after the pending
    stats are read); host-path and fused frames timed apart, except the
    host-path frames traced one by one (with `host_trace`: from
    HOST_TRACE_FROM until a keyframe and a tracking-only frame are among
    them), N_ONE_READ fused frames traced with their runtime calls checked
    (graphs: `one_read_faults`) and the last N_GRAPH_TRACE (fused frames,
    traced together, CUDA activity only). Under graphs no frame may capture
    a program, but for `_warm_ahead`'s inertial stages."""
    import numpy as np
    import torch

    from pli_slam_tpu_torch.frontend import graphs
    from pli_slam_tpu_torch.frontend.tracker import Tracker
    from pli_slam_tpu_torch.ops.kernels import hamming, rot3
    from pli_slam_tpu_torch.utils.profile import capture_stats, stage_captures

    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    mem0 = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    tracker = Tracker(cam, cfg, dev, cuda_graphs=cuda_graphs)
    construct_ms = (time.perf_counter() - t0) * 1e3
    tracker.streaming = True
    stats, poses, captured_in_frame = [], [], []
    finish = tracker._finish_fused

    def record(stamp, frame_stats, img_args):
        stats.append(frame_stats)
        return finish(stamp, frame_stats, img_args)

    tracker._finish_fused = record

    snapshot = {}

    def one(fr, mark=contextlib.nullcontext()):
        """(fused?, a host-path frame that made a keyframe?, ms) of one frame."""
        n0, c0, w0 = len(stats), _captures(tracker), set(tracker._warmed)
        with mark:
            f0 = time.perf_counter()
            tracker.process(fr["img_l"], fr["img_r"], fr["t"], imu=fr.get("imu"))
            dt = (time.perf_counter() - f0) * 1e3
        poses.append((tracker.R.clone(), tracker.t.clone()))
        fused = len(stats) > n0
        new = {k: n - c0.get(k, 0) for k, n in _captures(tracker).items() if n != c0.get(k, 0)}
        warmed = {kind for kind, _ in set(tracker._warmed) - w0}
        if new and not (warmed and set(new) <= {"imu_init", "vi_ba"}):
            captured_in_frame.append((len(poses) - 1, new))
        if len(poses) == snapshot_after:
            fs = tracker._fused_step()
            if fs is not None:
                fs.settle()  # the keyframe branch's launches of frames whose stats are pending
            snapshot.update({name: graphs.tree_clone(getattr(tracker, name)) for name in STORES})
            snapshot["launches"] = (hamming.launches, rot3.launches)
            snapshot["infos"] = [dict(info) for info in tracker.stats]
        return fused, not fused and tracker.frames_since_kf == 0, dt

    reset_counts()
    n_timed = len(frames) - N_GRAPH_TRACE
    one_read_at = n_timed - N_ONE_READ if cuda_graphs else n_timed  # eager frames read mid-frame: not checked
    timed, host_traced = [], []
    for i, fr in enumerate(frames[:one_read_at]):
        kinds = {kf for kf, _, _ in host_traced}
        if host_trace and i >= HOST_TRACE_FROM and len(kinds) < 2 and i < HOST_TRACE_FROM + HOST_TRACE_MAX:
            res = []
            _, _, launches, graph_launches = _traced(dev, lambda: res.append(one(fr)))
            fused, kf, _ = res[0]
            if not fused:
                host_traced.append((kf, launches, graph_launches))
        else:
            timed.append(one(fr))
    one_read = {}
    if one_read_at < n_timed:
        with FrameTrace(dev) as trace:
            fused_flags = {i: one(frames[i], trace.frame(i))[0] for i in range(one_read_at, n_timed)}
        one_read = {i: one_read_faults(trace.calls[i]) for i in trace.calls if fused_flags[i]}
        one_read["calls"] = {i: trace.calls[i] for i in trace.calls if fused_flags[i]}
    wall, busy_us, launches, graph_launches = _traced(dev, lambda: [one(fr) for fr in frames[n_timed:]])
    cap_ms, pool = capture_stats(tracker)
    rare = [p for p in tracker.stage_programs() if p.name in RARE_STAGES]
    fused_step = tracker._fused_step()
    fused_step.settle()
    return dict(rare={p.name: p.captures for p in rare}, rare_pool=sum(p.pool_bytes for p in rare), snapshot=snapshot,
                poses=poses, stats=[torch.from_numpy(s.read()) for s in stats], busy=busy_us / 1e6 / wall,
                fused_ms=np.asarray([dt for fused, _, dt in timed if fused]),
                host_ms=np.asarray([dt for fused, _, dt in timed if not fused]),
                host_kf=sum(1 for fused, kf, _ in timed if kf), host_traced=host_traced,
                launches=launches / N_GRAPH_TRACE, graph_launches=graph_launches / N_GRAPH_TRACE,
                capture_ms=cap_ms, pool=pool, stage_ms=stage_captures(tracker),
                fused_capture=(fused_step.captures, fused_step.capture_ms, fused_step.pool_bytes),
                replays=fused_step.replays, construct_ms=construct_ms,
                warmups={k: getattr(tracker, k) for k in ("fused_warmup_ms", "init_warmup_ms", "loop_warmup_ms")},
                captured_in_frame=captured_in_frame, one_read=one_read,
                peak=torch.cuda.max_memory_allocated(dev) - mem0,
                gated_match=hamming.launches, closest_rotation=count_small_kernels())


def _bits_equal(a, b) -> bool:
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if torch.equal(a, b):
        return True
    return a.is_floating_point() and bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def _first_difference(g: dict, e: dict) -> str | None:
    """Where two runs of phase 15 first differ in any bit over the frames
    both ran (`e` may be the shorter), or None."""
    if len(g["poses"]) < len(e["poses"]) or len(g["stats"]) < len(e["stats"]):
        return f"{len(g['poses'])} / {len(e['poses'])} frames, {len(g['stats'])} / {len(e['stats'])} fused frames"
    for i, ((Rg, tg), (Re, te)) in enumerate(zip(g["poses"], e["poses"])):
        for name, a, b in (("R", Rg, Re), ("t", tg, te)):
            if not _bits_equal(a, b):
                return f"frame {i}: {name} (largest difference {float((a - b).abs().max()):.3e})"
    for i, (a, b) in enumerate(zip(g["stats"], e["stats"])):
        if not _bits_equal(a, b):
            return f"fused frame {i}: the stats vector ({a.tolist()} / {b.tolist()})"
    if not g["snapshot"] or not e["snapshot"]:
        return "the stores: not copied"
    for i, (a, b) in enumerate(zip(g["snapshot"]["infos"], e["snapshot"]["infos"])):
        if a != b:
            return f"the record of frame {i} ({a} / {b})"
    if g["snapshot"]["launches"] != e["snapshot"]["launches"]:
        return f"the kernels' launch counts (gated_match, closest_rotation): {g['snapshot']['launches']} / " \
               f"{e['snapshot']['launches']}"
    for store in STORES:
        sg, se = g["snapshot"][store], e["snapshot"][store]
        for f in dataclasses.fields(sg):
            if not _bits_equal(getattr(sg, f.name), getattr(se, f.name)):
                return f"{store}.{f.name} after frame {len(e['poses']) - 1}"
    return None


def _pcts(ms) -> str:
    import numpy as np

    if not len(ms):
        return "none"
    return (f"fps {1e3 / ms.mean():.3f}, p50 {np.percentile(ms, 50):.2f} ms, p99 {np.percentile(ms, 99):.2f} ms, "
            f"worst {ms.max():.2f} ms over {len(ms)} frames")


def _side_line(label: str, r: dict) -> str:
    n_cap, cap_ms, cap_pool = r["fused_capture"]
    return (f"{label}: fused frames {_pcts(r['fused_ms'])}; from the host per traced fused frame "
            f"{r['launches']:.0f} kernel launches and {r['graph_launches']:.1f} graph launches; device busy "
            f"{100 * r['busy']:.1f}% of the traced window; Tracker construction {r['construct_ms']:.1f} ms, warm-ups "
            f"(ms) {r['warmups']}; the fused step: {n_cap} captures ({cap_ms:.1f} ms, graph pool "
            f"{cap_pool / 2**20:.1f} MiB), {r['replays']} replays; all captures {r['capture_ms']:.1f} ms, graph pools "
            f"{r['pool'] / 2**20:.1f} MiB; peak memory {r['peak'] / 2**20:.1f} MiB; launches: gated_match "
            f"{r['gated_match']}, closest_rotation {r['closest_rotation']}")


def _host_line(label: str, r: dict) -> str:
    traced = "; ".join(f"{'keyframe' if kf else 'tracking only'}: {n} kernel and {ng} graph launches"
                       for kf, n, ng in r["host_traced"])
    return (f"{label}: host-path frames {_pcts(r['host_ms'])} ({r['host_kf']} keyframes among them), the "
            f"first's stage captures included; traced one by one: {traced or 'none'}; stage captures (ms) "
            f"{r['stage_ms']}; the rare paths' stages: captures {r['rare']}, their graph pools "
            f"{r['rare_pool'] / 2**20:.1f} MiB")


def phase_graphs(dev, smi, room, vi):
    """15 (see the module docstring): graphs against eager on phase 4's and
    phase 5's frames, bit for bit over the eager runs' depths, host-path
    frames included."""
    import torch

    from pli_slam_tpu_torch.utils.profile import slice_camera, slice_config

    cam = slice_camera()
    for name, cfg, frames, n_eager, host_trace in (("visual", slice_config(), room, N_EAGER_VISUAL, False),
                                                    ("stereo-inertial", vi[0], vi[1], N_EAGER_VI, True)):
        g = phase_graphs_run(dev, cam, cfg, frames, True, n_eager, host_trace)
        e = phase_graphs_run(dev, cam, cfg, frames[:n_eager], False, n_eager, host_trace)
        for label, r in ((f"graphs, {len(frames)} frames", g), (f"eager, {n_eager} frames", e)):
            log(f"graphs 15 {name}: " + _side_line(label, r) + f" [{smi}]")
            log(f"graphs 15 {name}: " + _host_line(label, r) + f" [{smi}]")
        diff = _first_difference(g, e)
        if diff is not None:
            raise AssertionError(f"graphs 15 {name}: graphs and eager differ first at {diff}")
        if g["graph_launches"] != 1 or e["graph_launches"] != 0:
            raise AssertionError(f"graphs 15 {name}: graph launches per fused frame {g['graph_launches']} with "
                                 f"graphs (one program: 1), {e['graph_launches']} eager")
        checked = {k: v for k, v in g["one_read"].items() if k != "calls"}
        if not checked or any(checked.values()):
            raise AssertionError(f"graphs 15 {name}: the streaming fused frames' one read: {checked or 'none checked'} "
                                 f"(their runtime calls: {g['one_read'].get('calls')})")
        if g["captured_in_frame"]:
            raise AssertionError(f"graphs 15 {name}: captures inside frames (frame, captures by program): "
                                 f"{g['captured_in_frame']}")
        calls = next(iter(g["one_read"]["calls"].values()))
        log(f"graphs 15 {name}: {len(checked)} streaming fused frames traced with their runtime calls: each one graph "
            f"launch, no device-to-host copy but the stats vector's (non-blocking, into pinned memory), no stream or "
            f"device synchronisation, at most the wait on the previous frame's stats event; the first's calls "
            f"{sorted({n: sum(1 for m, _ in calls if m == n) for n, _ in calls}.items())}; no capture inside any "
            f"frame but _warm_ahead's [{smi}]")
        if host_trace:
            if not g["host_traced"] or not any(kf for kf, _, _ in g["host_traced"]):
                raise AssertionError(f"graphs 15 {name}: no host-path keyframe among the traced frames "
                                     f"({g['host_traced']})")
            worst = max(n for _, n, _ in g["host_traced"])
            if worst > HOST_LAUNCH_LIMIT or any(ng == 0 for _, _, ng in g["host_traced"]):
                raise AssertionError(f"graphs 15 {name}: a host-path frame under graphs issued {worst} kernel "
                                     f"launches (limit {HOST_LAUNCH_LIMIT}): a stage ran eagerly "
                                     f"({g['host_traced']})")
        log(f"graphs 15 {name}: over the eager run's {len(e['poses'])} frames every frame's (R, t) and record, every "
            f"fused frame's stats vector ({len(e['stats'])}), the stores after the last and the kernels' launches "
            f"{e['snapshot']['launches']} are bit-identical")
        del g, e
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 16: loop-closing trackers built, run and dropped one after another in one process
# ---------------------------------------------------------------------------


N_ROW_TRACKERS = 2  # plain Trackers of phase 16, then a System and two resets: five trackers
N_ROW_FRAMES = 6  # frames each tracks (phase 6a's first)
TRACKER_LEFT_BOUND = 4 * 2**20  # bytes a dropped tracker may leave reserved: two 2 MiB segments of small blocks, what
# the first tracker of a process leaves for its constants (ops.consts) and the gated-match kernel's counters


def _reserved(dev) -> int:
    """Device memory reserved once garbage is collected and the caching allocator's free blocks are given back."""
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved(dev)


def _row_frames(label: str, tracker, track, frames) -> list:
    """`track(fr)` over `frames`: every frame OK, no program captured inside a frame. Returns the states."""
    from pli_slam_tpu_torch.frontend.tracker import TrackingState

    states = []
    for i, fr in enumerate(frames):
        c0 = _captures(tracker)
        states.append(track(fr)["state"])
        new = {k: n - c0.get(k, 0) for k, n in _captures(tracker).items() if n != c0.get(k, 0)}
        if new:
            raise AssertionError(f"trackers 16: {label} captured {new} inside frame {i}")
    if any(st != TrackingState.OK for st in states):
        raise AssertionError(f"trackers 16: {label} tracked its frames as {states}")
    return states


def phase_trackers(dev, smi, run):
    """16: loop-closing trackers (phase 6a's configuration, SlamConfig.
    euroc_stereo() with loop closing on) built under graphs one after
    another in this process, each tracking phase 6a's first N_ROW_FRAMES
    frames and then dropped (ROADMAP queue 3 A8: the third of such trackers
    in a row failed its capture while the IF bodies' stream came from
    PyTorch's pool): N_ROW_TRACKERS `Tracker`s, then a `System` whose
    `reset()` builds two more. Each must capture its fused step at
    construction, track every frame, capture nothing inside a frame, and
    leave at most TRACKER_LEFT_BOUND bytes of device memory reserved once
    dropped (`gc.collect()`, `torch.cuda.empty_cache()`): a plain tracker
    against the level before it was built; a tracker that `reset()`
    replaced by the level after its successor tracked the same frames
    against the level after it did (the two are the same size); the
    System's last tracker with the System against the level before the
    System. Returns (gated_match launches, frames)."""
    from pli_slam_tpu_torch.frontend.tracker import Tracker
    from pli_slam_tpu_torch.ops.kernels import hamming
    from pli_slam_tpu_torch.system import System
    from pli_slam_tpu_torch.utils.profile import loop_config, slice_camera

    cfg, cam, frames = loop_config(), slice_camera(), run[2][:N_ROW_FRAMES]
    reset_counts()
    left, rows = [], []

    def captured(label, tracker):
        fused = tracker._fused_step()
        if fused.captures != 1 or fused.program is None:
            raise AssertionError(f"trackers 16: {label} did not capture its fused step at construction")
        rows.append(f"{label} construction {tracker.fused_warmup_ms:.0f} ms, fused-step pool "
                    f"{fused.pool_bytes / 2**20:.1f} MiB")

    for i in range(N_ROW_TRACKERS):
        before = _reserved(dev)
        tracker = Tracker(cam, cfg, dev)
        captured(f"Tracker {i}", tracker)
        _row_frames(f"Tracker {i}", tracker, lambda fr: tracker.process(fr["img_l"], fr["img_r"], fr["t"]), frames)
        tracker = None
        left.append((f"Tracker {i}", _reserved(dev) - before))
    base = _reserved(dev)
    sysm = System(cam, cfg, device=dev)
    alive = []
    for k in range(3):
        label = "System" if k == 0 else f"System after reset {k}"
        if k:
            sysm.reset()
        captured(label, sysm.tracker)
        _row_frames(label, sysm.tracker, lambda fr: sysm.track_stereo(fr["img_l"], fr["img_r"], fr["t"]), frames)
        alive.append(_reserved(dev))
        if k:  # the same tracker over the same frames in place of the one reset() dropped
            left.append((f"the tracker reset {k} replaced", alive[k] - alive[k - 1]))
    sysm = None
    left.append(("System's last tracker and the System", _reserved(dev) - base))
    launches = hamming.launches
    count_small_kernels()
    n_frames = (N_ROW_TRACKERS + 3) * N_ROW_FRAMES
    log(f"trackers 16: {N_ROW_TRACKERS} Trackers and a System reset twice ({N_ROW_TRACKERS + 3} loop-closing trackers "
        f"in a row, {N_ROW_FRAMES} frames each): each captured its fused step at construction, tracked every frame "
        f"and captured nothing inside one; {'; '.join(rows)}; device memory left reserved after each drop (B) "
        f"{left} (bound {TRACKER_LEFT_BOUND}); gated_match launches {launches} [{smi}]")
    worst = max(b for _, b in left)  # below zero: the level came back lower than before
    if worst > TRACKER_LEFT_BOUND:
        raise AssertionError(f"trackers 16: a dropped tracker left {worst} B of device memory reserved (bound "
                             f"{TRACKER_LEFT_BOUND}): {left}")
    if launches < n_frames:
        raise AssertionError(f"trackers 16: gated_match launched {launches} times for {n_frames} frames")
    return launches, n_frames


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test runs only on a GPU", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "pli_slam_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository (pli_slam_tpu_torch/ missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    dev = torch.device("cuda", 0)

    smi = nvidia_smi()
    log(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, count {torch.cuda.device_count()}")

    from concurrent.futures import ThreadPoolExecutor

    from pli_slam_tpu_torch.ops.kernels import conditional, eig4, hamming, rot3, svd_small

    with ThreadPoolExecutor(5) as pool:  # one nvcc per source, started together
        t_build, t_build_rot3, t_build_eig4, t_build_svd, t_build_cond = pool.map(
            lambda build: build(), (hamming.build, rot3.build, eig4.build, svd_small.build, conditional.build))
    log(f"build: gated_match ({KERNEL_SRC}) built and loaded in {t_build:.2f} s, closest_rotation ({ROT3_SRC}) in "
        f"{t_build_rot3:.2f} s, largest_eigvec ({EIG4_SRC}) in {t_build_eig4:.2f} s, svd_small ({SVD_SRC}) in "
        f"{t_build_svd:.2f} s, the IF nodes' handle kernel ({COND_SRC}) in {t_build_cond:.2f} s, in parallel")

    secs = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        try:
            out = fn(*args)
        except BaseException:
            secs[name] = round(time.perf_counter() - t0, 1)
            log(f"chip_smoke: phase {name} failed; seconds per phase so far {secs}")
            raise
        secs[name] = round(time.perf_counter() - t0, 1)
        return out

    max_err, times = timed("3", phase_kernels, dev)
    rot3_line = timed("3b", phase_rot3, dev)
    eig4_line = timed("3c", phase_eig4, dev)
    svd_line = timed("3d", phase_svd_small, dev)
    if_line = timed("3e", phase_if_node, dev)
    floor = rot3_line["launch_floor_ms"]
    log(f"kernels: per launch in a CUDA graph against the launch floor there ({floor:.4f} ms, a one-element add_): "
        + ", ".join(f"{name} {line['ms']:.4f} ms ({line['ms'] - floor:+.4f})" for name, line in (
            ("closest_rotation 1 x 3x3", rot3_line), ("closest_rotation 8 x 3x3", {"ms": rot3_line["ms_batch8"]}),
            ("largest_eigvec 256 x 4x4", eig4_line),
            ("svd_small 256 x 12x12", svd_line), ("svd_small 256 x 3x3", {"ms": svd_line["extra"]["ms_3x3"]}))))
    timed("4 stages", phase_small_reference, dev)
    launches, n_frames, room = timed("4", phase_main_path, dev, smi)
    launches_vi, n_frames_vi, vi = timed("5", phase_vi_path, dev, smi)
    launches_loop, n_frames_loop, run = timed("6a", phase_loop, dev, smi)
    launches_kidnap = timed("6b", phase_kidnap, dev, smi, run)
    launches_atlas = timed("6c", phase_atlas, dev, smi)
    launches_ra = launches_kidnap + launches_atlas
    launches_rgbd, n_fused_rgbd, rgbd_frames = timed("7", phase_rgbd, dev, smi)
    launches_mono, n_frames_mono = timed("8", phase_mono, dev, smi)
    small_main = timed("3c/3d main path", phase_small_main_path, dev)
    timed("rectifier", phase_rectifier, dev, smi)
    ingest = timed("9", phase_ingest, dev, smi, vi, rgbd_frames, room)
    launches_ingest = sum(n for n, _ in ingest.values())
    fisheye, fisheye_vi, assoc_ms = timed("10", phase_fisheye, dev, smi)
    slice6 = {"fisheye": fisheye, "fisheye_vi": fisheye_vi, "mono_vi": timed("11", phase_mono_vi, dev, smi),
              "rgbd_vi": timed("12", phase_rgbd_vi, dev, smi)}
    timed("13", phase_distribution, dev, smi)
    launches_14a, n_frames_14a = timed("14a", phase_flagship_closure, dev, smi, run)
    launches_14b, n_frames_14b = timed("14b", phase_bench, dev, smi, run, room)
    launches_flagship = launches_14a + launches_14b
    timed("15", phase_graphs, dev, smi, room, vi)
    launches_row, n_frames_row = timed("16", phase_trackers, dev, smi, run)
    log(f"chip_smoke: seconds per phase {secs}")
    for name, counts, phases in (("closest_rotation", ROT3_LAUNCHES, ("phase_main_path", "phase_loop")),
                                 ("largest_eigvec", EIG4_LAUNCHES, ("phase_loop", "phase_kidnap",
                                                                    "phase_flagship_closure")),
                                 ("svd_small", SVD_LAUNCHES, ("mono_planted_reloc", "phase_mono")),
                                 ("if_node", COND_LAUNCHES, ("phase_main_path", "phase_vi_path",
                                                             "phase_graphs_run", "phase_trackers"))):
        if any(counts.get(phase, 0) < 1 for phase in phases):
            raise AssertionError(f"{name} was not launched on every path that runs it: {counts}")

    from pli_slam_tpu_torch.utils.kernel_bench import bound_ms

    k_ms, p_ms, c_ms = times["track_r15"]
    kf_ms, pf_ms, cf_ms = times["fuse"]
    kk_ms, pk_ms, ck_ms = times["kitti_track_r15"]
    kkf_ms, pkf_ms, ckf_ms = times["kitti_fuse"]
    (b_ms, b_by), (bf_ms, _) = bound_ms(1200, 4096), bound_ms(1200, 16384)
    (bk_ms, _), (bkf_ms, _) = bound_ms(2000, 4096), bound_ms(2000, 16384)
    log(json.dumps({"kernels": [{
        "name": "gated_match", "route": "cuda", "source": KERNEL_SRC, "replaces": TPU_KERNEL,
        "launches": launches + launches_vi + launches_loop + launches_ra + launches_rgbd + launches_mono
        + launches_ingest + sum(n for n, _ in slice6.values()) + launches_flagship + launches_row,
        "max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": None, "call_ms": c_ms, "shape": "N=1200 x P=4096",
        "ms_fuse": kf_ms, "plain_ms_fuse": pf_ms, "bound_ms_fuse": bf_ms, "call_ms_fuse": cf_ms,
        "shape_fuse": "N=1200 x P=16384", "launches_visual": launches, "launches_vi": launches_vi,
        "launches_per_frame": launches / (n_frames - 1), "launches_per_frame_vi": launches_vi / (n_frames_vi - 1),
        "launches_loop": launches_loop, "launches_reloc_atlas": launches_ra,
        "launches_per_frame_loop": launches_loop / (n_frames_loop - 1), "launches_rgbd": launches_rgbd,
        "launches_per_frame_rgbd": launches_rgbd / n_fused_rgbd, "launches_mono": launches_mono,
        "launches_per_frame_mono": launches_mono / n_frames_mono,
        "ms_n2000": kk_ms, "plain_ms_n2000": pk_ms, "bound_ms_n2000": bk_ms, "call_ms_n2000": ck_ms,
        "shape_n2000": "N=2000 x P=4096", "ms_fuse_n2000": kkf_ms, "plain_ms_fuse_n2000": pkf_ms,
        "bound_ms_fuse_n2000": bkf_ms, "call_ms_fuse_n2000": ckf_ms, "shape_fuse_n2000": "N=2000 x P=16384",
        **{f"launches_{name}": n for name, (n, _) in ingest.items()},
        **{f"launches_per_frame_{name}": n / max(frames - 1, 1) for name, (n, frames) in ingest.items()},
        **{f"launches_{name}": n for name, (n, _) in slice6.items()},
        **{f"launches_per_frame_{name}": n / frames for name, (n, frames) in slice6.items()},
        "fisheye_association_ms": assoc_ms, "launches_flagship": launches_flagship,
        "launches_per_frame_flagship": launches_flagship / (n_frames_14a - 1 + n_frames_14b - 2),
        "launches_trackers_in_a_row": launches_row, "launches_per_frame_trackers_in_a_row": launches_row / n_frames_row,
    }, {
        "name": "closest_rotation", "route": "cuda", "source": ROT3_SRC, "replaces": ROT3_REPLACES,
        "launches": sum(ROT3_LAUNCHES.values()), "max_abs_err": rot3_line["max_abs_err"], "ms": rot3_line["ms"],
        "plain_ms": rot3_line["plain_ms"], "bound_ms": rot3_line["bound_ms"], "bound_by": rot3_line["bound_by"],
        "library_ms": rot3_line["library_ms"], "shape": "1 x 3 x 3 (a pose update of the main path)",
        "sweeps": rot3_line["sweeps"], "call_ms": rot3_line["call_ms"], "max_abs_err_float64": rot3_line["float64"],
        "graph_launch_floor_ms": rot3_line["launch_floor_ms"],
        **{key: rot3_line[key] for key in ("ms_batch8", "bound_ms_batch8", "ms_perturbed", "bound_ms_perturbed",
                                           "ptxas", "parent") if key in rot3_line},
        **{f"launches_{name.removeprefix('phase_')}": n for name, n in ROT3_LAUNCHES.items()},
    }, *[{
        "name": name, "route": "cuda", "source": src, "replaces": replaces, "launches": sum(counts.values()),
        "max_abs_err": line["max_abs_err"], "ms": line["ms"], "plain_ms": line["plain_ms"],
        "bound_ms": line["bound_ms"], "bound_by": line["bound_by"], "library_ms": line["library_ms"], "shape": shape,
        "sweeps": line["sweeps"], "call_ms": line["call_ms"],
        "max_abs_err_float64": {**{k: {"kernel": v["kernel"], "twin": v["twin"]} for k, v in line["hold"].items()},
                                "main_path": {k: {"kernel": small_main[k]["kernel"], "twin": small_main[k]["twin"]}
                                              for k in keys}},
        **{f"launches_{phase.removeprefix('phase_')}": n for phase, n in counts.items()},
        "ransac_counts_main_path": small_main["ransac_counts"], **line.get("extra", {}),
    } for name, src, replaces, line, counts, shape, keys in (
        ("largest_eigvec", EIG4_SRC, EIG4_REPLACES, eig4_line, EIG4_LAUNCHES, "256 x 4 x 4", ("horn",)),
        ("svd_small", SVD_SRC, SVD_REPLACES, svd_line, SVD_LAUNCHES, "256 x 12 x 12", ("svd12", "svd3")))], {
        "name": "if_node", "route": "cuda", "source": COND_SRC, "replaces": COND_REPLACES,
        "launches": sum(COND_LAUNCHES.values()), **if_line,
        "shape": "one 0-d bool predicate (two IF nodes a fused frame: K with and without windowed BA)",
        **{f"launches_{name.removeprefix('phase_')}": n for name, n in COND_LAUNCHES.items()},
    }]}))
    log(smi)
    log(f"chip_smoke: all phases passed in {time.perf_counter() - T_START:.1f} s")
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
