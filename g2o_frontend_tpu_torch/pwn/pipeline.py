"""Config-driven PWN pipeline: reference .conf files -> the port's configs
(counterpart of ``g2o_frontend_tpu/pwn/pipeline.py``).

The reference instantiates its whole SLAM pipeline by deserializing a boss
object graph (``pwn_tracker2/conf/pwn_slam_catacombs_gui.conf``, loaded at
``pwn_slam_app.cpp:41-59``). The same class names are registered here, in
the port's own boss registry (``io/boss.py``), as specs that build the
port's configs, so a reference-format config file parameterizes the port:

  PinholePointProjector            -> projector.PinholeProjector
  StatsCalculatorIntegralImage \
  PointInformationMatrixCalculator  -> converter.ConverterConfig
  NormalInformationMatrixCalculator/
  CorrespondenceFinder + Linearizer + Aligner -> aligner.AlignerConfig
  DepthImageConverterIntegralImage -> ConverterSpec (ties the above)
  PwnMatcherBase                   -> MatcherSpec (aligner @ scale)
  PwnTracker / PwnCloser / ManifoldVoronoiExtractor
                                   -> PwnTrackerConfig / CloserConfig /
                                      ManifoldVoronoiConfig

`load_pipeline(path)` returns a `PwnPipeline` of the wired configs.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np

from ..io import boss
from ..slam.manifold_voronoi import ManifoldVoronoiConfig
from ..slam.map_closer import CloserConfig
from ..slam.pwn_tracker import PwnTrackerConfig
from .aligner import AlignerConfig
from .converter import ConverterConfig
from .projector import PinholeProjector

# ---------------------------------------------------------------------------
# raw parameter holders (one per reference class name)
# ---------------------------------------------------------------------------


@boss.register(name="PinholePointProjector")
@dataclass
class PinholeProjectorSpec:
    cameraMatrix: Any = None
    imageRows: int = 480
    imageCols: int = 640
    minDistance: float = 0.01
    maxDistance: float = 6.0
    transform: Any = None
    baseline: float = 0.075
    alpha: float = 0.1

    def build(self, rows=None, cols=None) -> PinholeProjector:
        K = np.asarray(self.cameraMatrix).reshape(3, 3) if self.cameraMatrix is not None else np.array(
            [[525.0, 0, 319.5], [0, 525.0, 239.5], [0, 0, 1]]
        )
        # several reference confs store rows/cols swapped (640x480 images
        # declared imageRows=640); trust the camera matrix center
        r = rows or self.imageRows
        c = cols or self.imageCols
        if K[0, 2] * 2 > c and K[0, 2] * 2 <= r:
            r, c = c, r
        return PinholeProjector(
            rows=int(r),
            cols=int(c),
            fx=float(K[0, 0]),
            fy=float(K[1, 1]),
            cx=float(K[0, 2]),
            cy=float(K[1, 2]),
            min_distance=float(self.minDistance),
            max_distance=float(self.maxDistance),
        )


@boss.register(name="StatsCalculatorIntegralImage")
@dataclass
class StatsCalculatorSpec:
    worldRadius: float = 0.1
    imageMaxRadius: int = 30
    imageMinRadius: int = 10
    minPoints: int = 50
    curvatureThreshold: float = 0.2


@boss.register(name="PointInformationMatrixCalculator")
@dataclass
class PointInfoSpec:
    flatInformationMatrix: Any = None
    nonflatInformationMatrix: Any = None
    curvatureThreshold: float = 0.02


@boss.register(name="NormalInformationMatrixCalculator")
@dataclass
class NormalInfoSpec:
    flatInformationMatrix: Any = None
    nonflatInformationMatrix: Any = None
    curvatureThreshold: float = 0.02


@boss.register(name="CorrespondenceFinder")
@dataclass
class CorrespondenceFinderSpec:
    inlierDistanceThreshold: float = 0.5
    flatCurvatureThreshold: float = 0.02
    inlierCurvatureRatioThreshold: float = 1.3
    inlierNormalAngularThreshold: float = 0.866
    rows: int = 480
    cols: int = 640


@boss.register(name="Linearizer")
@dataclass
class LinearizerSpec:
    aligner: Any = None
    robustKernel: int = 1
    inlierMaxChi2: float = 9e3
    zScaling: int = 0


@boss.register(name="Aligner")
@dataclass
class AlignerSpec:
    outerIterations: int = 10
    innerIterations: int = 1
    projector: Any = None
    linearizer: Any = None
    correspondenceFinder: Any = None
    referenceSensorOffset: Any = None
    currentSensorOffset: Any = None


@boss.register(name="DepthImageConverterIntegralImage", aliases=("DepthImageConverter",))
@dataclass
class ConverterSpec:
    pointProjector: Any = None
    statsCalculator: Any = None
    pointInfoCalculator: Any = None
    normalInfoCalculator: Any = None

    def build_config(self) -> ConverterConfig:
        st = self.statsCalculator or StatsCalculatorSpec()
        pi = self.pointInfoCalculator or PointInfoSpec()
        kw = dict(
            world_radius=float(st.worldRadius),
            min_image_radius=int(st.imageMinRadius),
            max_image_radius=int(st.imageMaxRadius),
            min_points=int(st.minPoints),
            curvature_threshold=float(pi.curvatureThreshold),
        )
        if getattr(pi, "flatInformationMatrix", None) is not None:
            m = np.asarray(pi.flatInformationMatrix).reshape(4, 4)
            kw["point_flat_info"] = (float(m[0, 0]), float(m[1, 1]), float(m[2, 2]))
        ni = self.normalInfoCalculator
        if ni is not None and getattr(ni, "flatInformationMatrix", None) is not None:
            m = np.asarray(ni.flatInformationMatrix).reshape(4, 4)
            kw["normal_flat_info"] = (float(m[0, 0]), float(m[1, 1]), float(m[2, 2]))
            m2 = np.asarray(ni.nonflatInformationMatrix).reshape(4, 4)
            kw["normal_nonflat_info"] = (float(m2[0, 0]), float(m2[1, 1]), float(m2[2, 2]))
        return ConverterConfig(**kw)

    def build_projector(self) -> PinholeProjector:
        spec = self.pointProjector or PinholeProjectorSpec()
        return spec.build()


@boss.register(name="PwnMatcherBase")
@dataclass
class MatcherSpec:
    aligner: Any = None
    converter: Any = None
    scale: int = 1
    frameInlierDepthThreshold: float = 50.0

    def build_aligner_config(self) -> AlignerConfig:
        al = self.aligner or AlignerSpec()
        cf = getattr(al, "correspondenceFinder", None) or CorrespondenceFinderSpec()
        ln = getattr(al, "linearizer", None) or LinearizerSpec()
        return AlignerConfig(
            outer_iterations=int(al.outerIterations),
            inner_iterations=int(al.innerIterations),
            inlier_distance_threshold=float(cf.inlierDistanceThreshold),
            inlier_normal_angular_threshold=float(cf.inlierNormalAngularThreshold),
            flat_curvature_threshold=float(cf.flatCurvatureThreshold),
            inlier_curvature_ratio_threshold=float(cf.inlierCurvatureRatioThreshold),
            inlier_max_chi2=float(ln.inlierMaxChi2),
            robust_kernel=bool(ln.robustKernel),
        )


@boss.register(name="PwnTracker")
@dataclass
class TrackerSpec:
    name: str = ""
    manager: Any = None
    matcher: Any = None
    cache: Any = None
    topic: str = ""
    minCloudInliers: int = 3000
    newFrameCloudInliersFraction: float = 0.4
    frameMinNonZeroThreshold: int = 3000
    frameMaxOutliersThreshold: int = 1000
    frameMinInliersThreshold: int = 3000

    def build(self) -> PwnTrackerConfig:
        slots = 50
        if self.cache is not None:
            slots = int(getattr(self.cache, "maxSlots", slots))
        return PwnTrackerConfig(
            new_frame_inliers_fraction=float(self.newFrameCloudInliersFraction),
            min_cloud_inliers=int(self.minCloudInliers),
            cache_slots=slots,
        )


@boss.register(name="PwnCloser")
@dataclass
class CloserSpec:
    name: str = ""
    manager: Any = None
    matcher: Any = None
    cache: Any = None
    poseAcceptanceCriterion: Any = None
    relationSelector: Any = None
    consensusInlierTranslationalThreshold: float = 0.5
    consensusInlierRotationalThreshold: float = 0.261799
    consensusMinTimesCheckedThreshold: int = 3
    frameMinNonZeroThreshold: int = 3000
    frameMaxOutliersThreshold: int = 100
    frameMinInliersThreshold: int = 3000
    closureClampingDistance: float = 0.5

    def build(self) -> CloserConfig:
        kw = {}
        crit = self.poseAcceptanceCriterion
        if crit is not None and hasattr(crit, "translationalDistance"):
            kw["translational_distance"] = float(crit.translationalDistance)
            kw["rotational_distance"] = float(getattr(crit, "rotationalDistance", 0.785398))
        return CloserConfig(
            consensus_inlier_translational_threshold=float(self.consensusInlierTranslationalThreshold),
            consensus_inlier_rotational_threshold=float(self.consensusInlierRotationalThreshold),
            consensus_min_times_checked=int(self.consensusMinTimesCheckedThreshold),
            frame_min_nonzero_threshold=int(self.frameMinNonZeroThreshold),
            frame_max_outliers_threshold=int(self.frameMaxOutliersThreshold),
            frame_min_inliers_threshold=int(self.frameMinInliersThreshold),
            closure_clamping_distance=float(self.closureClampingDistance),
            **kw,
        )


@boss.register(name="PwnCloudCache")
@dataclass
class CloudCacheSpec:
    converter: Any = None
    scale: int = 1
    topic: str = ""
    minSlots: int = 50
    maxSlots: int = 50


@boss.register(name="DistancePoseAcceptanceCriterion")
@dataclass
class DistanceCriterionSpec:
    manager: Any = None
    translationalDistance: float = 3.0
    rotationalDistance: float = 0.785398


@boss.register(name="ManifoldVoronoiExtractor")
@dataclass
class ManifoldVoronoiSpec:
    name: str = ""
    manager: Any = None
    cache: Any = None
    resolution: float = 0.2
    xSize: int = 100
    ySize: int = 100
    normalThreshold: float = 0.64
    dequeSize: int = 30

    def build(self) -> ManifoldVoronoiConfig:
        return ManifoldVoronoiConfig(
            resolution=float(self.resolution),
            x_size=int(self.xSize),
            y_size=int(self.ySize),
            normal_threshold=float(self.normalThreshold),
            deque_size=int(self.dequeSize),
        )


@dataclass
class PwnPipeline:
    """Fully-wired PWN processing configs from a config file."""

    projector: PinholeProjector
    converter_config: ConverterConfig
    aligner_config: AlignerConfig
    scale: int = 1
    tracker_config: PwnTrackerConfig | None = None
    closer_config: CloserConfig | None = None
    voronoi_config: ManifoldVoronoiConfig | None = None
    extras: dict = field(default_factory=dict)

    def scaled_projector(self) -> PinholeProjector:
        return self.projector.scaled(self.scale) if self.scale > 1 else self.projector


def load_pipeline(path) -> PwnPipeline:
    """Load a reference-format .conf and wire the port's configs from it."""
    de = boss.Deserializer(path)
    objs = de.read_all()
    matcher = next((o for o in objs if isinstance(o, MatcherSpec)), None)
    conv = next((o for o in objs if isinstance(o, ConverterSpec)), None)
    if conv is None and matcher is not None:
        conv = matcher.converter
    if conv is None:
        conv = ConverterSpec()
    al_cfg = (
        matcher.build_aligner_config()
        if matcher is not None
        else MatcherSpec(aligner=next((o for o in objs if isinstance(o, AlignerSpec)), None)).build_aligner_config()
    )
    tracker = next((o for o in objs if isinstance(o, TrackerSpec)), None)
    closer = next((o for o in objs if isinstance(o, CloserSpec)), None)
    voronoi = next((o for o in objs if isinstance(o, ManifoldVoronoiSpec)), None)
    cache = next((o for o in objs if isinstance(o, CloudCacheSpec)), None)
    scale = int(matcher.scale) if matcher is not None else 1
    if cache is not None:
        scale = max(scale, int(cache.scale))
    return PwnPipeline(
        projector=conv.build_projector(),
        converter_config=conv.build_config(),
        aligner_config=al_cfg,
        scale=scale,
        tracker_config=tracker.build() if tracker is not None else None,
        closer_config=closer.build() if closer is not None else None,
        voronoi_config=voronoi.build() if voronoi is not None else None,
        extras={"by_name": de.by_name, "objects": objs},
    )
