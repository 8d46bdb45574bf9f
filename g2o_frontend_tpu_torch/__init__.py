"""g2o_frontend_tpu_torch — the PyTorch/CUDA port of g2o_frontend_tpu.

The JAX package ``g2o_frontend_tpu`` stays the reference; this package is
its counterpart in PyTorch, with the Pallas kernels replaced by kernels
written by hand for NVIDIA Hopper (``csrc/``). It imports ``torch`` and
never ``jax``; of the JAX package it imports only the host-only modules
``io.tum``, ``io.image_codec`` and ``graph.map_manager``.

Slice 1 is PWN dense RGB-D odometry:

utils     SE3 Lie maps, synthetic scenes, ATE.
ops       sym6 algebra, integral images, closed-form eigh3x3, and the fused
          aligner (CUDA kernel + its plain PyTorch version).
pwn       Cloud, pinhole projector, depth->cloud converter, aligner.
slam      Keyframe tracker and whole-sequence odometry.
apps      The ``pwn_odometry`` command line.

Float32 matrix products and convolutions must not drop to TF32: the 6x6
solves and the per-pixel algebra are compared with the JAX reference in
full float32, so importing the package turns TF32 off for both
``torch.backends.cuda.matmul`` and ``torch.backends.cudnn``.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
