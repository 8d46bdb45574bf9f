"""g2o_frontend_tpu_torch — the PyTorch/CUDA port of g2o_frontend_tpu.

The JAX package ``g2o_frontend_tpu`` stays the reference; this package is
its counterpart in PyTorch, with the Pallas kernels replaced by kernels
written by hand for NVIDIA Hopper (``csrc/``). It imports ``torch`` and
never ``jax``, and nothing of the JAX package: the numpy-only modules it
needs from there (``io/tum.py``, ``io/boss.py``, ``io/image_codec.py``,
``graph/map_manager.py``, ``graph/pipeline.py``, ``ops/voronoi_graph.py``)
are copied.

Slice 1 is PWN dense RGB-D odometry; slice 2 is PWN SLAM with loop closing;
the rest of PWN follows:

utils     SE3 Lie maps, synthetic scenes, ATE, profiling.
io        TUM sequences and trajectories; boss serialization and its image
          codecs; map and pytree checkpoints.
ops       sym6 algebra, integral images, closed-form eigh3x3, the fused
          aligner systems (one, and K candidates against one current
          cloud), the z-buffer linearizer and the gather probes: CUDA
          kernels, each with its plain PyTorch version; the jump-flood
          distance transform and the Voronoi graph.
pwn       Cloud, pinhole / multi / cylindrical projectors, depth->cloud
          converter, aligner (``align``, ``align_batch``), reference-format
          ``.conf`` pipelines, cloud merger, voxels, planes, depth
          calibration, ``.pwn`` cloud files.
graph     Map manager, flat SE3 pose graph, map <-> solver reflector,
          stream processors.
solvers   PCG, block-tridiagonal cyclic reduction, SE3 LM optimizer.
slam      Keyframe tracker, matcher, loop closer, map merger with cloud
          fusion, manifold Voronoi extractor.
apps      The ``pwn_odometry``, ``pwn_slam``, ``cloud_aligner`` and
          ``profile_gather`` command lines.
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
