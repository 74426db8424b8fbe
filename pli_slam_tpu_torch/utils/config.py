"""Configuration for the SLAM pipeline: the port's own copy.

Same names, fields and defaults as the JAX package's `utils/config.py`;
`utils.convert.config_from_reference` turns `dataclasses.asdict` of that
package's config into this one, so tests run both on the same settings.

Replaces the reference's dual config system — the ORB-SLAM3 style
`cv::FileStorage` YAML parsing (reference: src/Tracking.cc:144,677,761)
and the PL-SLAM `Config` singleton of ~90 tunables (reference:
include/Config.h:39-149) — with one typed, immutable dataclass tree.
Defaults mirror the reference's EuRoC operating point
(Examples/Stereo-Inertial/Config/EuRoC.yaml).

Static capacity fields (`n_*_max`) set the padded array shapes that the
whole data model is allocated at.
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class OrbConfig:
    """ORB extractor budget (reference: EuRoC.yaml:111-117, ORBextractor ctor)."""

    n_features: int = 1200
    n_levels: int = 8
    scale_factor: float = 1.2
    fast_threshold: int = 20
    fast_min_threshold: int = 7
    patch_size: int = 31
    edge_threshold: int = 19


@dataclasses.dataclass(frozen=True)
class LineConfig:
    """Line extractor budget (reference: EuRoC.yaml:129-132,184-192, Config.h lsd_* keys)."""

    n_lines: int = 256  # reference lsd_nfeatures cap is <=500; 256 is our padded budget
    min_length_frac: float = 0.025  # min length as fraction of min(W,H) (Config::minLineLength)
    grad_threshold: float = 30.0
    n_bands: int = 9  # LBD bands
    band_width: int = 7
    lbd_samples: int = 16  # along-line sample count for the LBD grid
    # Hough-based detector (dense replacement for LSD region growing)
    theta_bins: int = 180
    rho_res: float = 2.0
    n_voters: int = 16384  # strongest edge pixels that cast Hough votes
    n_candidates: int = 256  # Hough peaks considered before segment NMS
    n_samples: int = 288  # along-line support samples per candidate
    support_angle_deg: float = 22.5
    max_gap: int = 4  # tolerated support gap, in samples
    sigma_px: float = 2.0  # endpoint-to-line measurement noise (Hough sample quantization)


@dataclasses.dataclass(frozen=True)
class MatchConfig:
    """Matching thresholds (reference: ORBmatcher.cc TH_LOW/TH_HIGH, LineMatcher ratios)."""

    orb_th_low: int = 50
    orb_th_high: int = 100
    nn_ratio: float = 0.9
    line_nn_ratio: float = 0.75
    search_radius_px: float = 15.0
    stereo_max_disparity: float = 192.0
    check_orientation: bool = True


@dataclasses.dataclass(frozen=True)
class TrackingConfig:
    """Tracking state machine thresholds (reference: src/Tracking.cc)."""

    min_init_features: int = 500  # StereoInitialization gate (Tracking.cc:1930)
    min_matches_motion: int = 20
    min_matches_ref_kf: int = 15
    min_inliers_track: int = 10  # pose-opt inlier floor (Tracking.cc:3373-3404)
    min_inliers_local_map: int = 30
    kf_min_interval: int = 0  # min frames between KFs
    kf_max_interval: int = 30  # c1a: MaxFrames = fps (Tracking.cc:3407)
    kf_ref_ratio: float = 0.75  # c2: tracked < ratio * ref visible (Tracking.cc:3500)
    kf_min_inliers: int = 25  # c1c floor: never cement a weakly-tracked pose
    # as a keyframe (reference NeedNewKeyFrame requires matches > 15,
    # src/Tracking.cc:3500 c1c) — a KF created from a garbage pose spawns
    # duplicate landmarks at wrong depths and deforms the early map
    kf_min_close_points: int = 100  # close-point creation cap (Tracking.cc:3573)
    kf_max_new_points: int = 512  # per-KF landmark creation budget, closest-first
    recently_lost_sec: float = 5.0  # time_recently_lost (Tracking.cc:53)
    motion_model: bool = True


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """Optimization budgets (reference: EuRoC.yaml:196-198, Optimizer.cc)."""

    pose_gn_iters: int = 5  # stage-1 GN (Config::maxIters)
    pose_gn_iters_refine: int = 10  # refinement (Config::maxItersRef)
    pose_rounds: int = 4  # GN -> outlier -> GN rounds (Optimizer.cc:1146-1163)
    # inertial per-frame solve rounds: each GN iteration re-linearizes
    # points+lines+IMU sequentially, so the 15-dof solve's latency is
    # iteration-bound on an accelerator; 2 rounds (15 iterations) tracks as well as
    # 4 in practice because the IMU prediction is already a near-optimal
    # seed (the reference spends 4x10 g2o iterations, but on CPU where
    # iterations are nearly free)
    pose_rounds_inertial: int = 2
    mad_k: float = 4.0  # MAD inlier factor (Config::inlierK)
    local_ba_iters: int = 6  # g2o optimize(5)+optimize(10) analog — g2o's
    # LM typically converges the window in the first handful and the
    # reference aborts opportunistically (mbAbortBA); 6 (2 + 4 after
    # outlier reclassification) measured ATE-neutral at half the cost
    local_ba_window: int = 8  # covisible-KF window size (padded capacity)
    local_ba_fixed: int = 2  # fixed boundary KFs
    # windowed-BA landmark compaction caps: the solve runs over the ids
    # actually observed in the window (<= W * obs-slots unique) instead
    # of the full padded stores — ~4x less Schur work per iteration at
    # production capacities. Global BA stays uncompacted.
    ba_pt_cap: int = 4096
    ba_ln_cap: int = 512
    pgo_iters: int = 20  # essential-graph optimize(20) (Optimizer.cc:2689)
    gba_iters: int = 10
    huber_mono: float = 2.447  # sqrt(5.991) g2o delta for 2-dof chi2
    huber_stereo: float = 2.796  # sqrt(7.815) for 3-dof
    damping_init: float = 1e-4
    ba_max_pose_step: float = 0.5  # per-iteration pose twist trust region
    ba_max_landmark_step: float = 1.0  # per-iteration landmark step cap
    prune_chi2_pt: float = 7.815  # stage-2 outlier gate, 3-dof (Optimizer.cc:2196)
    prune_chi2_ln: float = 5.991  # 2-dof endpoint-distance chi2


@dataclasses.dataclass(frozen=True)
class ImuConfig:
    """IMU noise model (reference: EuRoC.yaml:44-49, IMU::Calib)."""

    rate_hz: float = 200.0
    noise_gyro: float = 1.7e-4
    noise_acc: float = 2e-3
    walk_gyro: float = 1.94e-5
    walk_acc: float = 3e-3
    gravity: float = 9.81
    max_samples_per_frame: int = 32  # padded preintegration batch per frame
    init_time_sec: float = 2.0  # min data span before IMU init
    init_min_kfs: int = 10  # min keyframes before IMU init (LocalMapping.cc:1164)
    # previous-frame state uncertainty folded into the per-frame IMU
    # factor (the reference's EdgePriorPoseImu marginalization prior,
    # include/G2oTypes.h:703): rotation [rad], velocity [m/s], position [m]
    prev_sigma_rot: float = 3.5e-3
    prev_sigma_vel: float = 0.02
    prev_sigma_pos: float = 5e-3
    # Body->camera extrinsics T_bc as 16 row-major floats (None = identity).
    # The reference parses this as "Tbc" from the YAML (src/Tracking.cc:761)
    # into IMU::Calib; EuRoC's actual value has a ~90 deg rotation component.
    Tbc: tuple | None = None


@dataclasses.dataclass(frozen=True)
class MapConfig:
    """Static capacities of the struct-of-arrays map stores."""

    max_keyframes: int = 512
    max_points: int = 16384
    max_lines: int = 4096
    # tracking matches against a LOCAL-MAP subset of this many point
    # slots (the covisibility neighborhood of the newest keyframe —
    # reference Tracking::UpdateLocalPoints/SearchLocalPoints,
    # src/Tracking.cc:3767/:3942) instead of the full padded store:
    # 4x less per-frame matching work at production capacity
    local_map_points: int = 4096
    local_map_kfs: int = 8  # covis neighbors whose observations seed it
    max_obs_per_kf_points: int = 1536  # per-KF point observation slots
    max_obs_per_kf_lines: int = 256
    cull_found_ratio: float = 0.25  # MapPointCulling (LocalMapping.cc:301)
    cull_min_obs: int = 3
    kf_cull_redundancy: float = 0.9  # KeyFrameCulling (LocalMapping.cc:895)


@dataclasses.dataclass(frozen=True)
class LoopConfig:
    """Loop closing / place recognition (reference: LoopClosing.cc, KeyFrameDatabase.cc)."""

    enabled: bool = True
    consistency_kfs: int = 3  # >=3 consecutive KF hits (LoopClosing.cc:306)
    min_kf_gap: int = 12  # guard before attempting detection (LoopClosing.cc:259-278)
    bow_candidates: int = 3  # DetectNBestCandidates(3) (LoopClosing.cc:395)
    run_gba: bool = True  # global BA after loop correction (LoopClosing.cc:1087)
    # amortize the post-loop global BA over subsequent frames instead of
    # blocking the loop-closure frame: the PGO-corrected map is usable
    # immediately and refinement chunks run one per frame — the
    # deterministic analog of the reference's transient GBA thread racing
    # LocalMapping (src/LoopClosing.cc:1087, :2287-2335), with the
    # after-the-fact reconciliation made unnecessary because each chunk
    # operates on the live map
    gba_amortize: bool = True
    gba_chunk_iters: int = 3  # LM iterations per amortized chunk
    sim3_hypotheses: int = 256  # batched RANSAC hypotheses (replaces iterate())
    sim3_min_inliers: int = 20
    # projection re-verification (reference DetectAndReffineSim3FromLastKF
    # nNumProjMatches gates, src/LoopClosing.cc:429): the candidate's map
    # must re-project onto the current AND previous keyframes' landmarks
    # — deliberately stricter than sim3_min_inliers
    proj_min_inliers: int = 30
    proj_radius_px: float = 10.0
    vocab_levels: int = 4
    vocab_branching: int = 10


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    sensor: str = "stereo"  # stereo | stereo_imu | mono | mono_imu | rgbd
    width: int = 752
    height: int = 480
    fps: float = 20.0
    use_points: bool = True  # Config::hasPoints kill-switch
    use_lines: bool = True  # Config::hasLines kill-switch
    orb: OrbConfig = OrbConfig()
    lines: LineConfig = LineConfig()
    match: MatchConfig = MatchConfig()
    tracking: TrackingConfig = TrackingConfig()
    opt: OptimizerConfig = OptimizerConfig()
    imu: ImuConfig = ImuConfig()
    map: MapConfig = MapConfig()
    loop: LoopConfig = LoopConfig()

    def replace(self, **kw: Any) -> "SlamConfig":
        return dataclasses.replace(self, **kw)

    @staticmethod
    def euroc_stereo() -> "SlamConfig":
        return SlamConfig(sensor="stereo")

    @staticmethod
    def euroc_stereo_inertial() -> "SlamConfig":
        return SlamConfig(sensor="stereo_imu")

    @staticmethod
    def tiny_test() -> "SlamConfig":
        """Small capacities for fast unit/integration tests on CPU."""
        return SlamConfig(
            width=128,
            height=96,
            orb=OrbConfig(n_features=256, n_levels=3),
            lines=LineConfig(n_lines=32),
            map=MapConfig(max_keyframes=32, max_points=1024, max_lines=128,
                          max_obs_per_kf_points=256, max_obs_per_kf_lines=32),
            imu=ImuConfig(max_samples_per_frame=16),
            tracking=TrackingConfig(min_init_features=20, min_matches_motion=8,
                                    min_matches_ref_kf=8, min_inliers_track=6,
                                    min_inliers_local_map=10, kf_min_inliers=8),
        )


def load_yaml(path: str) -> SlamConfig:
    """Load a reference-style YAML (EuRoC.yaml schema) into SlamConfig.

    Supports the subset of keys the pipeline consumes; unknown keys are
    ignored (the reference likewise ignores unknown FileStorage nodes).
    """
    kv = parse_yaml_flat(path)
    mats = parse_yaml_matrices(path)

    def get(key: str, default, cast=float):
        return cast(kv[key]) if key in kv else default

    orb = OrbConfig(
        n_features=get("ORBextractor.nFeatures", 1200, int),
        n_levels=get("ORBextractor.nLevels", 8, int),
        scale_factor=get("ORBextractor.scaleFactor", 1.2),
        fast_threshold=get("ORBextractor.iniThFAST", 20, int),
        fast_min_threshold=get("ORBextractor.minThFAST", 7, int),
    )
    tbc = mats.get("Tbc")
    imu = ImuConfig(
        rate_hz=get("IMU.Frequency", 200.0),
        noise_gyro=get("IMU.NoiseGyro", 1.7e-4),
        noise_acc=get("IMU.NoiseAcc", 2e-3),
        walk_gyro=get("IMU.GyroWalk", 1.94e-5),
        walk_acc=get("IMU.AccWalk", 3e-3),
        Tbc=tuple(float(x) for x in tbc[1]) if tbc is not None else None,
    )
    return SlamConfig(
        width=get("Camera.width", 752, int),
        height=get("Camera.height", 480, int),
        fps=get("Camera.fps", 20.0),
        use_points=bool(get("has_points", 1, int)),
        use_lines=bool(get("has_lines", 1, int)),
        orb=orb,
        imu=imu,
    )


def load_yaml_full(path: str):
    """Full-fidelity load of a reference-style YAML: returns
    (SlamConfig, Camera, rectification | None). The rectification is the
    dict of the eight K/D/R/P blocks as float64 arrays (keys `LEFT.K` ...
    `RIGHT.P`), the arguments a stereo rectifier is built from.

    Mirrors everything Tracking::ParseCamParamFile/ParseORBParamFile/
    ParseIMUParamFile consume (reference: src/Tracking.cc:144-770):
    camera intrinsics (from the rectified LEFT./RIGHT. P blocks when
    rectification is configured, else the Camera.fx/... scalars), the
    stereo baseline Camera.bf (or -P_r[0,3]), the rectification K/D/R/P
    blocks, Tbc, IMU noise, and the ORB/line budgets.
    """
    import numpy as np

    from pli_slam_tpu_torch.ops.camera import Camera

    cfg = load_yaml(path)
    kv = parse_yaml_flat(path)
    mats = parse_yaml_matrices(path)

    def mat(name):
        if name not in mats:
            return None
        (r, c), data = mats[name]
        return np.asarray(data, np.float64).reshape(r, c)

    rectifier = None
    names = ["LEFT.K", "LEFT.D", "LEFT.R", "LEFT.P",
             "RIGHT.K", "RIGHT.D", "RIGHT.R", "RIGHT.P"]
    if all(n in mats for n in names):
        rectifier = {n: mat(n).reshape(-1) if n.endswith(".D") else mat(n) for n in names}
        P_l = rectifier["LEFT.P"]
        P_r = rectifier["RIGHT.P"]
        cam = Camera.pinhole(
            fx=float(P_l[0, 0]), fy=float(P_l[1, 1]),
            cx=float(P_l[0, 2]), cy=float(P_l[1, 2]),
            bf=float(-P_r[0, 3]),
            width=cfg.width, height=cfg.height,
        )
    else:
        cam = Camera.pinhole(
            fx=float(kv.get("Camera.fx", 0.0)), fy=float(kv.get("Camera.fy", 0.0)),
            cx=float(kv.get("Camera.cx", 0.0)), cy=float(kv.get("Camera.cy", 0.0)),
            bf=float(kv.get("Camera.bf", 0.0)),
            width=cfg.width, height=cfg.height,
        )
    return cfg, cam, rectifier


def parse_yaml_flat(path: str) -> dict[str, str]:
    """Scalar `key: value` pairs from a reference-style YAML (the subset
    cv::FileStorage emits for scalar nodes)."""
    import re

    kv: dict[str, str] = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].rstrip()
            m = re.match(r"([A-Za-z0-9_.]+)\s*:\s*(.+)", line.strip())
            if m and "opencv-matrix" not in m.group(2):
                kv[m.group(1)] = m.group(2).strip().strip('"')
    return kv


def parse_yaml_matrices(path: str) -> dict[str, tuple[tuple[int, int], list[float]]]:
    """`!!opencv-matrix` nodes (rows/cols/data) from a reference-style
    YAML — the format of Tbc and the LEFT./RIGHT. K/D/R/P rectification
    blocks (reference: src/Tracking.cc:144-770 FileStorage reads,
    Examples/Stereo-Inertial/Config/EuRoC.yaml:55-104).

    Returns {name: ((rows, cols), data_row_major)}.
    """
    import re

    text = open(path).read()
    out: dict[str, tuple[tuple[int, int], list[float]]] = {}
    pat = re.compile(
        r"([A-Za-z0-9_.]+)\s*:\s*!!opencv-matrix\s*\n"
        r"\s*rows\s*:\s*(\d+)\s*\n\s*cols\s*:\s*(\d+)\s*\n"
        r"\s*dt\s*:\s*\w+\s*\n\s*data\s*:\s*\[([^\]]*)\]",
        re.MULTILINE,
    )
    for m in pat.finditer(text):
        name = m.group(1)
        rows, cols = int(m.group(2)), int(m.group(3))
        data = [float(x) for x in m.group(4).replace("\n", " ").split(",") if x.strip()]
        out[name] = ((rows, cols), data)
    return out
