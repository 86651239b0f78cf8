"""Static configuration for the TPU-native RGB-D SLAM engine.

Design: the reference keeps compile-time ``constexpr`` parameter namespaces plus a
static camera-intrinsics singleton loaded from YAML (reference: src/parameters.hpp:10-112,
src/parameters.cpp:10-74).  Here everything is a frozen dataclass: hyper-parameters are
*static* (hashable, used as jit-static args / Python constants baked into traces) and the
camera model is a small pytree of arrays passed explicitly — no global mutable state, which
keeps every function pure and jittable.

Units follow the reference: millimeters for distances, pixels for screen space, radians
for angles unless suffixed ``_d`` (degrees).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field


@dataclass(frozen=True)
class DepthNoiseModel:
    """Kinect depth-quantization noise model (reference: src/parameters.hpp:13-18,
    src/utils/covariances.cpp:12-19).

    Minimum depth disparity at depth z (mm) is ``a + b*z + c*z^2``, floored at 0.5 mm.
    The constants are stored in the reference's published units ("2012 - 3D with Kinect")
    and rescaled exactly as covariances.cpp does.
    """

    sigma_error: float = 2.73       # quadratic term, scaled by (1/1000)^2
    sigma_multiplier: float = 0.74  # linear term, scaled by 1/1000
    sigma_margin: float = -0.53     # constant term
    floor_mm: float = 0.5

    @property
    def quadratic(self) -> float:
        return self.sigma_error * (1.0 / 1000.0) ** 2

    @property
    def linear(self) -> float:
        return self.sigma_multiplier / 1000.0

    @property
    def constant(self) -> float:
        return self.sigma_margin


@dataclass(frozen=True)
class RansacConfig:
    """RANSAC thresholds (reference: src/parameters.hpp:22-44)."""

    max_retroprojection_error_point2d_px: float = 3.0
    max_retroprojection_error_point_px: float = 3.0
    max_retroprojection_error_plane_mm: float = 50.0
    max_retroprojection_error_plane_normal: float = 0.2
    # lines in pose optimization are NEW vs the reference (its line path is
    # compiled out, rgbd_slam.cpp:304-313); px gate follows the point convention
    max_retroprojection_error_line_px: float = 3.0
    # NOTE: the reference's 80% early-stop (pose_optimization.cpp:218-223) has
    # no equivalent here by design — all RANSAC hypotheses evaluate in one
    # lockstep batch, so there is nothing to stop early (see PARITY.md).
    probability_of_success: float = 0.8
    inlier_proportion: float = 0.65
    feature_trust_count: float = 10.0

    min_point_count: int = 5      # minimumPointForOptimization
    min_point2d_count: int = 5    # minimumPoint2dForOptimization
    min_plane_count: int = 3      # minimumPlanesForOptimization

    @property
    def max_iterations(self) -> int:
        """Iteration count from the standard RANSAC success-probability formula
        (reference: src/pose_optimization/pose_optimization.cpp:129-132)."""
        num = math.log(1.0 - self.probability_of_success)
        den = math.log(1.0 - self.inlier_proportion ** self.feature_trust_count)
        return max(1, int(math.ceil(num / den)))


@dataclass(frozen=True)
class DetectionConfig:
    """Feature detection parameters (reference: src/parameters.hpp:47-87)."""

    # keypoints
    tracked_mask_radius_px: float = 15.0
    keypoint_cell_detection_height_count: int = 3
    keypoint_cell_detection_width_count: int = 3
    max_point_per_frame: int = 100
    keypoint_refresh_frequency: int = 5

    # optical flow.  The reference gates the fwd-bwd round trip with
    # matchSearchRadius_px = 30 (keypoint_detection.cpp:174); here the gate is
    # a separate, much tighter knob (deviation, conservative direction): a
    # consistent track's round trip is sub-pixel, and gating at the RANSAC
    # 3 px inlier scale rejects drifting associations the 30 px gate admits —
    # measured on the room-orbit bench this IMPROVES ATE 17.7 -> 16.3 mm while
    # the short backward pass (optical_flow_backward_depth) pays for itself.
    optical_flow_roundtrip_px: float = 3.0
    # LK convergence epsilon in px (reference: TermCriteria eps 0.03,
    # keypoint_detection.cpp:284-285)
    optical_flow_eps_px: float = 0.03
    optical_flow_pyramid_depth: int = 4
    # Window side for pyramid levels >= optical_flow_coarse_from_level.
    # 53 = reference behavior (cv reuses the full winSize at every level) and
    # the shipped default.  Measured alternatives (round 5): 27 is SLOWER
    # in-kernel (40-row slabs miss the power-of-two sublane-roll fast path and
    # it converges in more iterations); 21 is ~30% faster and slightly better
    # on the nominal orbit (ATE 13.3 vs 14.3 mm) but doubles hard-scene ATE
    # (29 -> 52-60 mm regardless of which level it starts at) — the window
    # must stay wide wherever occluder rims / noise pathologies live.
    optical_flow_coarse_window_px: int = 53
    # first pyramid level the coarse window applies to (ATE-gated deviation;
    # levels below it keep the full window)
    optical_flow_coarse_from_level: int = 1
    optical_flow_window_height: int = 9
    optical_flow_window_width: int = 12
    optical_flow_iterations: int = 10
    # Backward-validation depth (TPU-native deviation, ATE-gated in bench):
    # the reference's backward pass is a second FULL-pyramid cv call
    # (keypoint_detection.cpp:329-338); here it runs zero-seeded from this
    # pyramid level down.  The skipped coarse levels only matter for flows
    # beyond the start level's convergence basin, which the round-trip gate
    # rejects either way.  Set to optical_flow_pyramid_depth for exact
    # reference behavior.  0 = finest level only, measured value-identical on
    # the nominal orbit (ATE 14.314 both ways) and statistically identical on
    # the hard-scene 3-seed spread ([27.6,29.1,49.9] vs [27.6,29.3,49.2])
    # while saving ~160 us/frame of kernel time.
    optical_flow_backward_depth: int = 0

    # FAST detector: the reference's empirical points->threshold curve
    # thr(points) = scale * decay^points (keypoint_detection.cpp:48-65).  The
    # engine evaluates it on the CURRENT point deficit at the high (normal
    # tier) and low (more-sensitive fallback tier) multipliers; at full
    # deficit (maximumPointPerFrame) this gives the reference's 24 / 8.
    fast_curve_scale: float = 41.2378
    fast_curve_decay: float = 0.99945
    fast_deficit_mult_high: float = 10.0
    fast_deficit_mult_low: float = 30.0

    def fast_threshold_curve(self, points_to_detect: float) -> int:
        """Empirical FAST points->threshold curve (reference:
        keypoint_detection.cpp:49-52)."""
        return int(math.ceil(
            self.fast_curve_scale * (self.fast_curve_decay ** points_to_detect)))

    @property
    def fast_threshold(self) -> int:
        """Static normal-tier threshold (curve at 10x maximumPointPerFrame)."""
        return self.fast_threshold_curve(
            self.fast_deficit_mult_high * self.max_point_per_frame)

    @property
    def fast_threshold_low(self) -> int:
        """Static sensitive-tier threshold (curve at 30x maximumPointPerFrame)."""
        return self.fast_threshold_curve(
            self.fast_deficit_mult_low * self.max_point_per_frame)

    # inverse depth
    inverse_depth_baseline: float = 1.0 / 1000.0      # 1/mm
    inverse_depth_angle_baseline_d: float = 0.5       # degrees

    # plane detection (CAPE)
    min_plane_seed_proportion: float = 0.8 / 100.0
    min_cell_activated_proportion: float = 0.65 / 100.0
    min_zero_depth_proportion: float = 0.7
    max_plane_merge_angle_d: float = 18.0
    max_plane_merge_distance_mm: float = 50.0
    depth_patch_size_px: int = 20

    # cylinder RANSAC
    cylinder_ransac_sqrt_max_distance: float = 0.04
    cylinder_ransac_min_score: float = 75.0
    cylinder_ransac_inlier_proportion: float = 0.33
    cylinder_ransac_probability_of_success: float = 0.8


@dataclass(frozen=True)
class MatchingConfig:
    """Feature matching parameters (reference: src/parameters.hpp:89-100)."""

    min_plane_overlap_for_match: float = 0.4  # IoU-like inter/area gate
    max_plane_match_angle_d: float = 20.0
    max_plane_match_distance_mm: float = 100.0
    match_search_radius_px: float = 30.0
    max_match_distance: float = 0.7  # Lowe ratio for descriptor matching
    # line matching gates (new surface; angle follows the plane-angle convention,
    # perpendicular distance the point search radius)
    max_line_match_angle_d: float = 10.0
    max_line_match_distance_px: float = 20.0


@dataclass(frozen=True)
class MappingConfig:
    """Local map lifecycle parameters (reference: src/parameters.hpp:102-110)."""

    point_unmatched_count_to_loose: int = 10
    plane_unmatched_count_to_loose: int = 10
    point_staged_age_confidence: int = 3
    point_min_confidence_for_map: float = 0.9
    # plane staged lifecycle (reference: src/map_management/map_primitive.cpp:286-288)
    plane_staged_promote_hits: int = 4
    plane_staged_drop_misses: int = 2

    # fixed SoA capacities (TPU design: masked fixed-size arrays replace the reference's
    # unordered_map feature containers, SURVEY.md §7).  Occupancy measured on
    # the room/hard orbits peaks at 224 alive 3D / 8 alive 2D points, so these
    # could shrink to ~320/64 — but capacity feeds the per-slot RNG stream and
    # RANSAC subset draws, and the hard-scene ATE is chaotically sensitive to
    # that reshuffle (29 -> 70 mm swing from a capacity change that never
    # binds); kept at the round-4 values that the recorded accuracy baselines
    # were measured with
    max_points_3d: int = 512
    max_points_2d: int = 256
    max_planes: int = 32
    max_lines: int = 16
    # LK-tracked subset cap: optical flow cost is linear in tracked points; the
    # reference caps detections at 100/frame and tracks visible map points.
    # Measured trade-offs (round 5): 104 gives +10 fps (318) with room-orbit
    # ATE intact but regresses the tunnel (7.4 -> 9.7 mm: forward flight has
    # high feature turnover and needs the extra tracked slots), so 128 stays
    # the default.  A cap of 96 (deliberately below the 100-point detection
    # deficit gate) turns detection into a continuous strong-corner top-up:
    # ate 10.8, hard-median 24.2, at ~310 fps — the accuracy-maximal config.
    max_tracked_points: int = 128
    # per-frame cap on matched planes that get the O(V^2) polygon merge
    # (params/cov still update past it); overflow is counted in
    # StepOutput.n_plane_merge_dropped — no silent caps
    plane_merge_cap: int = 8


@dataclass(frozen=True)
class EngineConfig:
    """Top-level engine behavior (reference: src/rgbd_slam.cpp)."""

    max_failed_tracking: int = 3      # consecutive failures before tracking lost
    min_depth_mm: float = 40.0        # src/coordinates/point_coordinates.cpp:16
    max_depth_mm: float = 6000.0      # src/coordinates/point_coordinates.cpp:17
    pose_covariance_mc_iterations: int = 100  # pose_optimization.cpp:361-437
    lm_iterations: int = 10           # fixed-iteration batched LM (replaces Eigen LM;
                                      # deferred accept/reject, one linearize/iter)
    refit_lm_iterations: int = 6      # final LM refit on the best inlier set: starts
                                      # from an already-optimized hypothesis, so it
                                      # needs fewer iterations than the subset solves
                                      # (it is the frame's longest sequential chain)
    ransac_hypothesis_batch: int = 32 # batched hypotheses replace the tbb loop
                                      # (the reference's own formula gives ~25
                                      # iterations, pose_optimization.cpp:129-132)
    p3p_hypothesis_batch: int = 16    # closed-form P3P minimal-subset hypotheses
                                      # added to the pool (north-star batched P3P;
                                      # up to 4 candidate poses per subset)
    # Constant-velocity pose prediction for the matching gates + LM init.
    # Default OFF for parity: the reference implements the model but disables
    # it in the main loop (`#if 0`, rgbd_slam.cpp:176-180).  Worth enabling on
    # occlusion-heavy sequences (bench ablation: ate_hard leg).
    use_motion_model_prediction: bool = False


@dataclass(frozen=True)
class SlamConfig:
    depth_noise: DepthNoiseModel = field(default_factory=DepthNoiseModel)
    ransac: RansacConfig = field(default_factory=RansacConfig)
    detection: DetectionConfig = field(default_factory=DetectionConfig)
    matching: MatchingConfig = field(default_factory=MatchingConfig)
    mapping: MappingConfig = field(default_factory=MappingConfig)
    engine: EngineConfig = field(default_factory=EngineConfig)

    def replace(self, **kw) -> "SlamConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class CameraIntrinsics:
    """Pinhole camera model for one camera.  Static (Python floats) so that projection
    code can bake them into jitted traces; the reference equivalent is the static
    ``Parameters::get_camera_1_*`` accessors (src/parameters.hpp:119-191)."""

    width: int = 640
    height: int = 480
    fx: float = 550.0
    fy: float = 550.0
    cx: float = 320.0
    cy: float = 240.0

    @property
    def matrix(self):
        import numpy as np

        return np.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]]
        )


@dataclass(frozen=True)
class CameraSetup:
    """RGB (camera 1) + depth (camera 2) rig, mirroring the reference's two-camera YAML
    config (examples/configuration_example.yaml, src/parameters.cpp:10-74)."""

    rgb: CameraIntrinsics = field(default_factory=CameraIntrinsics)
    depth: CameraIntrinsics = field(default_factory=CameraIntrinsics)
    # depth->rgb extrinsics as a 4x4 row-major tuple (static); identity by default
    depth_to_rgb: tuple = (
        (1.0, 0.0, 0.0, 0.0),
        (0.0, 1.0, 0.0, 0.0),
        (0.0, 0.0, 1.0, 0.0),
        (0.0, 0.0, 0.0, 1.0),
    )


def load_camera_yaml(path: str) -> CameraSetup:
    """Parse the reference's camera YAML format — the exact key names of
    examples/configuration_example.yaml (camera_1_focal_x, ...,
    camera_2_translation_offset_x; parser parity: src/parameters.cpp:10-57).
    Uses a minimal hand parser to avoid an OpenCV FileStorage dependency.

    The camera-2 (depth) offsets build the depth->rgb extrinsic 4x4 used by
    ``ops.depth_cloud.rectify_depth`` (reference:
    depth_map_transformation.cpp:23-87): translation in mm, rotation as euler
    angles in radians (parameters.cpp:38-49)."""
    import math

    values: dict[str, float] = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if ":" in line:
                key, _, val = line.partition(":")
                try:
                    values[key.strip()] = float(val.strip())
                except ValueError:
                    continue

    def cam(prefix: str) -> CameraIntrinsics:
        return CameraIntrinsics(
            width=int(values.get(f"{prefix}_size_x", 640)),
            height=int(values.get(f"{prefix}_size_y", 480)),
            fx=values.get(f"{prefix}_focal_x", 550.0),
            fy=values.get(f"{prefix}_focal_y", 550.0),
            cx=values.get(f"{prefix}_center_x", 320.0),
            cy=values.get(f"{prefix}_center_y", 240.0),
        )

    rx = values.get("camera_2_rotation_offset_x", 0.0)
    ry = values.get("camera_2_rotation_offset_y", 0.0)
    rz = values.get("camera_2_rotation_offset_z", 0.0)
    tx = values.get("camera_2_translation_offset_x", 0.0)
    ty = values.get("camera_2_translation_offset_y", 0.0)
    tz = values.get("camera_2_translation_offset_z", 0.0)
    # Rotation parity quirk: parameters.cpp:44-48 passes (rotX, rotY, rotZ) to
    # the EulerAngles(yaw, pitch, roll) ctor (types.hpp:80), so yaw=rotX,
    # pitch=rotY, roll=rotZ; get_quaternion_from_euler_angles then composes
    # AngleAxis(roll,X)*AngleAxis(pitch,Y)*AngleAxis(yaw,Z)
    # (angle_utils.cpp:6-12) — i.e. the matrix is Rx(rotZ)*Ry(rotY)*Rz(rotX).
    # Mirror that exactly so non-axis-aligned depth->rgb offsets rectify the
    # same way they do upstream.
    def _rot_x(a):
        c, s = math.cos(a), math.sin(a)
        return [[1.0, 0.0, 0.0], [0.0, c, -s], [0.0, s, c]]

    def _rot_y(a):
        c, s = math.cos(a), math.sin(a)
        return [[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]]

    def _rot_z(a):
        c, s = math.cos(a), math.sin(a)
        return [[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]]

    def _matmul(a, b):
        return [[sum(a[i][k] * b[k][j] for k in range(3)) for j in range(3)]
                for i in range(3)]

    r = _matmul(_rot_x(rz), _matmul(_rot_y(ry), _rot_z(rx)))
    depth_to_rgb = tuple(
        tuple(r[i]) + (t,) for i, t in enumerate((tx, ty, tz))
    ) + ((0.0, 0.0, 0.0, 1.0),)

    return CameraSetup(rgb=cam("camera_1"), depth=cam("camera_2"),
                       depth_to_rgb=depth_to_rgb)


# Default TUM freiburg1 intrinsics (TUM fr1 standard calibration)
TUM_FR1 = CameraIntrinsics(width=640, height=480, fx=517.3, fy=516.5, cx=318.6, cy=255.3)
DEFAULT_CONFIG = SlamConfig()
