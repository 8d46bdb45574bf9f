"""The aligner's Gauss-Newton step kernel (``gauss_newton_step_kernel`` of
``csrc/fused_aligner.cu``) by itself on the card.

The aligner's path, ``ops/fused_aligner.fused_step``, launches kernel 1 and
the step kernel back to back and keeps kernel 1's block rows and the step's
dx and sums to itself. These launchers take the two apart through the
library's C entries, so that a check can hold the step kernel against
``fused_aligner.step_reference`` on rows it knows:

- `block_rows`: kernel 1's (n_blocks, 29) block rows at `params`, and the
  (29,) sums that ``reduce_blocks_kernel`` makes of them (``fused_system``'s
  launch, with the scratch kept).
- `step_kernel`: the step kernel alone on given block rows and invT; its
  whole state (invT, params, dx, sums).

Neither counts in ``fused_aligner.launches`` or ``step_launches``, which
count the aligner's own launches. Used by the card tests of
``tests/test_torch_gn_step.py`` and by ``chip_smoke.py``'s phase 4.
"""
import torch

from g2o_frontend_tpu_torch.ops import fused_aligner as fa


def _cuda(x, name):
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA tensors, got {x.device}")
    return x.device


def block_rows(cur_packed, ref_table, params, projector, cfg):
    """Kernel 1's block rows at `params` and their reduced sums: ((n, 29),
    (29,)) float32 on the card, launched on the current stream."""
    dev = _cuda(cur_packed, "block_rows")
    H, W = projector.rows, projector.cols
    fa._check(cur_packed, ref_table, params, H, W)
    lib = fa._load()
    with torch.cuda.device(dev):
        rows = torch.empty((lib.fused_aligner_blocks(H * W), fa.N_SUMS), dtype=torch.float32, device=dev)
        sums = torch.empty(fa.N_SUMS, dtype=torch.float32, device=dev)
        err = lib.fused_aligner_launch(cur_packed.data_ptr(), ref_table.data_ptr(), params.data_ptr(),
                                       rows.data_ptr(), sums.data_ptr(), H, W, *fa._geometry(projector, cfg, dev))
    if err != 0:
        raise RuntimeError(f"fused_aligner kernel launch failed: CUDA error {err}")
    return rows, sums


def step_kernel(rows, invT, damping, reorthonormalize):
    """The step kernel alone on (n, 29) block rows and invT (4, 4), float32
    on the card: (invT (4, 4), params (24,), dx (6,), sums (29,))."""
    dev = _cuda(rows, "the step kernel")
    fa._check_tensors(dev, ("rows", rows, (rows.shape[0], fa.N_SUMS)), ("invT", invT, (4, 4)))
    if rows.shape[0] < 1:
        raise ValueError("the step kernel needs at least one block row")
    lib = fa._load()
    with torch.cuda.device(dev):
        state = torch.empty(fa.N_STATE, dtype=torch.float32, device=dev)
        err = lib.gauss_newton_step_launch(rows.data_ptr(), rows.shape[0], invT.data_ptr(), damping,
                                           int(bool(reorthonormalize)), state.data_ptr(),
                                           torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gauss_newton_step launch failed: CUDA error {err}")
    return fa._split_state(state)
