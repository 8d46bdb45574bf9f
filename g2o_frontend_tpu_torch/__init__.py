"""g2o_frontend_tpu_torch — the PyTorch/CUDA port of g2o_frontend_tpu.

The JAX package ``g2o_frontend_tpu`` stays the reference; this package is
its counterpart in PyTorch, with the Pallas kernels replaced by kernels
written by hand for NVIDIA Hopper (``csrc/``). It imports ``torch`` and
never ``jax``, and nothing of the JAX package: the numpy-only modules it
needs from there (``io/tum.py``, ``io/boss.py``, ``io/image_codec.py``,
``io/g2o.py``, ``io/sensors.py``, ``graph/map_manager.py``,
``graph/pipeline.py``, ``ops/voronoi_graph.py``, ``solvers/control.py``,
``slam/validated_slam.py``, ``utils/viz.py``, ``native/fastg2o.cpp`` and
the numpy part of ``slam/simulator.py``) are copied.

Slice 1 is PWN dense RGB-D odometry; slice 2 is PWN SLAM with loop closing;
the rest of PWN follows; slice 3 is the 2D pose-graph backend; slice 4 is
2D SLAM with unknown data association; slice 5 is laser grid SLAM, line
SLAM, the plane graph and bundle adjustment; slice 6 is the distributed
solvers:

utils     SE2 and SE3 Lie maps, synthetic scenes, ATE, profiling, PNG
          renderings.
laser     Likelihood grids, FFT and coarse-to-fine correlative scan
          matching, gradient refinement, line extraction.
io        TUM sequences and trajectories; boss serialization and its image
          codecs; map and pytree checkpoints; .g2o files; sensor
          synchronization.
native    The .g2o tokenizer (C++, built with g++ into ``_build/``).
ops       sym6 algebra, integral images, closed-form eigh3x3, the fused
          aligner systems (one, and K candidates against one current
          cloud), the z-buffer linearizer and the gather probes: CUDA
          kernels, each with its plain PyTorch version; the jump-flood
          distance transform and the Voronoi graph.
pwn       Cloud, pinhole / multi / cylindrical projectors, depth->cloud
          converter, aligner (``align``, ``align_batch``), reference-format
          ``.conf`` pipelines, cloud merger, voxels, planes, depth
          calibration, ``.pwn`` cloud files.
graph     Map manager, flat SE2 and SE3 pose graphs, map <-> solver
          reflector, stream processors.
solvers   PCG, block-tridiagonal cyclic reduction, SE2 and SE3 LM
          optimizers, the dense and Schur-complement SE2 solvers, the line
          and plane landmark graphs, Schur-complement BA, the float64 host
          control.
ransac    Batched RANSAC hypotheses and their solvers.
parallel  The mesh of shards (all in one process, or one torch.distributed
          rank a device), the halo exchange, SPIKE, the edge-sharded and
          pose-partitioned SE2 / SE3 / BA solvers and the distributed
          Schur solver.
slam      Keyframe tracker, matcher, loop closer, map merger with cloud
          fusion, manifold Voronoi extractor, world simulators, the 2D
          feature tracker with constellations and graph merge, submap grid
          SLAM, line SLAM.
models    Named pipeline presets (``models.build``).
apps      The ``pwn_odometry``, ``pwn_slam``, ``cloud_aligner``,
          ``profile_gather``, ``graph_optimizer``, ``boss_tools``,
          ``tracker_parity`` and ``tracker2d`` command lines.
conf      A reference-format PWN SLAM pipeline for the bundled sequence.

Float32 matrix products and convolutions must not drop to TF32: the 6x6
solves and the per-pixel algebra are compared with the JAX reference in
full float32, so importing the package turns TF32 off for both
``torch.backends.cuda.matmul`` and ``torch.backends.cudnn``.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
