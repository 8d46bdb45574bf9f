"""g2o_frontend_tpu_torch — the PyTorch/CUDA port of g2o_frontend_tpu.

The JAX package ``g2o_frontend_tpu`` stays the reference; this package is
its counterpart in PyTorch, with the Pallas kernels replaced by kernels
written by hand for NVIDIA Hopper (``csrc/``). It imports ``torch`` and
never ``jax``, and nothing of the JAX package: the numpy-only modules it
needs from there (``io/tum.py``, ``graph/map_manager.py``) are copied.

Slice 1 is PWN dense RGB-D odometry; slice 2 is PWN SLAM with loop closing:

utils     SE3 Lie maps, synthetic scenes, ATE.
io        TUM sequences and trajectories; map checkpoints.
ops       sym6 algebra, integral images, closed-form eigh3x3, the fused
          aligner systems (one, and K candidates against one current
          cloud) and the z-buffer linearizer: CUDA kernels, each with its
          plain PyTorch version.
pwn       Cloud, pinhole projector, depth->cloud converter, aligner
          (``align``, ``align_batch``).
graph     Map manager, flat SE3 pose graph, map <-> solver reflector.
solvers   PCG, block-tridiagonal cyclic reduction, SE3 LM optimizer.
slam      Keyframe tracker, matcher, loop closer, map merger.
apps      The ``pwn_odometry`` and ``pwn_slam`` command lines.

Float32 matrix products and convolutions must not drop to TF32: the 6x6
solves and the per-pixel algebra are compared with the JAX reference in
full float32, so importing the package turns TF32 off for both
``torch.backends.cuda.matmul`` and ``torch.backends.cudnn``.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
