"""Model families: named, config-instantiable SLAM pipeline presets
(counterpart of ``g2o_frontend_tpu/models/__init__.py``).

The reference composes its pipelines from JSON object-graph configs
(``pwn_tracker2/conf/*.conf``, ``pwn_slam_app.cpp:41-59``) and from per-app
flag sets (``datasets/2D/params.txt``). Each family builds the host-side
loop wired to the port's compute path on `device`, with the reference's
defaults.

Families (reference counterparts):
- ``pwn_rgbd_odometry`` — keyframe RGB-D odometry (`pwn_tracker`)
- ``pwn_rgbd_slam``     — tracker + loop closer + reflected optimizer
                          (`pwn_tracker2`'s full pipeline)
- ``tracker2d``         — 2D landmark SLAM with unknown data association
                          (`slam/tracker_test`)
- ``grid_slam``         — submap scan-matching SLAM (`mapper/graph_slam`)
- ``line_slam``         — 2D line-landmark SLAM (`line_alignment`)

Use ``build(name, **overrides)`` or the family functions directly; every
return value is a tracker object with a ``process_*`` ingest method.
"""
from __future__ import annotations

from typing import Any

__all__ = [
    "FAMILIES",
    "build",
    "pwn_rgbd_odometry",
    "pwn_rgbd_slam",
    "tracker2d",
    "grid_slam",
    "line_slam",
]


def pwn_rgbd_odometry(
    rows: int = 240,
    cols: int = 320,
    conf: str | None = None,
    kf_fraction: float = 0.4,
    device="cuda",
    **kw: Any,
):
    """Keyframe RGB-D odometry (`PwnTracker`) on `device`: from a
    reference-format `conf`, or a Kinect preset (`sensor`) scaled to
    rows x cols with `kw` as aligner settings."""
    from ..pwn.aligner import AlignerConfig
    from ..pwn.converter import ConverterConfig
    from ..slam.pwn_tracker import PwnTracker, PwnTrackerConfig

    if conf:
        from ..pwn.pipeline import load_pipeline

        pipe = load_pipeline(conf)
        proj, ccfg, acfg = pipe.scaled_projector(), pipe.converter_config, pipe.aligner_config
    else:
        from ..io import tum
        from ..pwn.projector import PinholeProjector

        fx, fy, cx, cy = tum.kinect_presets[kw.pop("sensor", "kinect")]
        s = 480 // rows
        proj = PinholeProjector(rows=rows, cols=cols, fx=fx / s, fy=fy / s, cx=cx / s, cy=cy / s,
                                min_distance=0.3, max_distance=6.0)
        ccfg = ConverterConfig(min_image_radius=max(2, 10 // s), max_image_radius=max(4, 30 // s),
                               min_points=max(10, 50 // (s * s)))
        acfg = AlignerConfig(**kw) if kw else AlignerConfig()
    return PwnTracker(proj, ccfg, acfg, PwnTrackerConfig(new_frame_inliers_fraction=kf_fraction), device=device)


def pwn_rgbd_slam(closer_overrides: dict | None = None, **kw: Any):
    """Tracker + loop closer + reflected optimizer, composed.

    Returns (tracker, closer, reflector); feed depths to
    ``tracker.process_frame``, then run closures and optimization through
    the closer and the reflector (what `apps/pwn_slam.py` drives end to
    end). `kw` goes to `pwn_rgbd_odometry`, `device` included.
    """
    from ..graph.reflector import MapReflector
    from ..slam.map_closer import CloserConfig, MapCloser

    tracker = pwn_rgbd_odometry(**kw)
    closer = MapCloser(tracker.manager, tracker.cache, tracker.projector, tracker.acfg,
                       CloserConfig(**(closer_overrides or {})))
    reflector = MapReflector(tracker.manager, device=tracker.device)
    return tracker, closer, reflector


#: datasets/2D/params.txt command lines as named config presets (the JAX
#: package's values, measured and tuned there in EVAL §5)
TRACKER2D_RECIPES = {
    # tracker_test all-default flags; the every-50 global+merge cadence
    # lives in the caller's loop
    "world1000-dense-highnoise": dict(
        incremental_ransac_inlier_threshold=0.3,
        local_map_size=5,
        optimize_each_n=5,
        min_landmark_creation_frames=3,
    ),
    # params.txt world-2000 recipe
    "world2000": dict(
        min_landmark_creation_frames=1,
        incremental_ransac_inlier_threshold=0.5,
        loop_ransac_inlier_threshold=0.2,
        loop_landmark_merge_distance=0.5,
        local_map_size=10,
        optimize_each_n=20,
    ),
    # params.txt victoria recipe (incl -odometryIsGood)
    "victoria": dict(
        loop_landmark_merge_distance=2.0,
        local_map_size=50,
        incremental_guess_max_feature_distance=2.0,
        incremental_ransac_inlier_threshold=1.0,
        loop_guess_max_feature_distance=60.0,
        loop_ransac_inlier_threshold=2.0,
        odometry_is_good=True,
        global_optimize_iters=30,
        cg_iters=150,
    ),
}


def tracker2d(recipe: str | None = None, device="cuda", **kw: Any):
    """2D unknown-data-association landmark SLAM (`FeatureTracker2D`) on
    `device`.

    recipe: optional params.txt preset name (TRACKER2D_RECIPES); explicit
    keyword overrides win over the preset values.
    """
    from ..slam.feature_tracker import FeatureTracker2D, Tracker2DConfig

    base = dict(TRACKER2D_RECIPES[recipe]) if recipe else {}
    base.update(kw)
    return FeatureTracker2D(Tracker2DConfig(**base), device=device)


def grid_slam(device="cuda", **kw: Any):
    """Submap grid SLAM (`GridSlam2D`) on `device`; `kw` are
    `GridSlamConfig` fields."""
    from ..slam.grid_slam import GridSlam2D, GridSlamConfig

    return GridSlam2D(GridSlamConfig(**kw), device=device)


def line_slam(device="cuda", **kw: Any):
    """2D line-landmark SLAM (`LineSlam2D`) on `device`; `kw` are
    `LineSlam2DConfig` fields."""
    from ..slam.line_slam import LineSlam2D, LineSlam2DConfig

    return LineSlam2D(LineSlam2DConfig(**kw), device=device)


FAMILIES = {
    "pwn_rgbd_odometry": pwn_rgbd_odometry,
    "pwn_rgbd_slam": pwn_rgbd_slam,
    "tracker2d": tracker2d,
    "grid_slam": grid_slam,
    "line_slam": line_slam,
}


def build(name: str, **overrides: Any):
    """Instantiate a model family by name with config overrides."""
    try:
        family = FAMILIES[name]
    except KeyError:
        raise ValueError(f"unknown family {name!r}; have {sorted(FAMILIES)}") from None
    return family(**overrides)
