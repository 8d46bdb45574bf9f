"""Vectorized generalized RANSAC (counterpart of
``g2o_frontend_tpu/ransac/engine.py``): K hypotheses scored at once.

Replaces the reference's serial `GeneralizedRansac` loop
(``ransac/ransac.h:130-208``):

1. K minimal index sets drawn at once by the Gumbel top-k trick,
2. all K minimal problems solved by one batched call of the closed-form
   solver (`solvers.py`),
3. every correspondence scored against every hypothesis, a (K, N) error
   matrix,
4. the best hypothesis by masked inlier count, ties broken by low error,
5. two guarded refinement rounds: re-fit on the running inlier set, kept
   only if it loses no inlier.

Everything is fixed-shape and stays on the data's device; invalid entries
are masked, never compacted. The draws come from a `torch.Generator` on
its own device (a CPU generator gives the same hypotheses whatever device
scores them), or are passed in as `minimal_sets`: the JAX package draws
from ``jax.random``, whose stream torch cannot reproduce, so its draws are
fed in that way to hold the two packages to one another.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class RansacResult(NamedTuple):
    transform: torch.Tensor  # best refined transform
    inliers: torch.Tensor  # (N,) bool
    n_inliers: torch.Tensor  # () int
    error: torch.Tensor  # () mean inlier error
    ok: torch.Tensor  # () bool: enough inliers found


def _sample_minimal_sets(generator: torch.Generator, n_hyp: int, minimal_size: int, mask) -> torch.Tensor:
    """(n_hyp, minimal_size) int64 index sets on the generator's device,
    distinct within each set, drawn among the valid entries of `mask`
    (N,) while there are enough. Masked entries get a Gumbel value of
    -inf; a stable sort takes their ties in index order (as
    ``lax.top_k`` does), so a set draws the lowest masked indices when
    fewer than `minimal_size` entries are valid."""
    mask = torch.as_tensor(mask, device=generator.device)
    u = torch.rand((n_hyp, mask.shape[0]), generator=generator, device=generator.device)
    g = torch.where(mask[None, :], -torch.log(-torch.log(u)), -torch.inf)
    return torch.sort(g, dim=1, descending=True, stable=True).indices[:, :minimal_size]


def _score(e, mask, inlier_threshold):
    inl = (e < inlier_threshold) & mask
    cnt = inl.sum(-1)
    err = torch.where(inl, e, 0.0).sum(-1) / torch.clamp_min(cnt, 1)
    return inl, cnt, err


def ransac(
    generator: torch.Generator | None,
    data1,
    data2,
    mask,
    fit_fn: Callable,
    err_fn: Callable,
    minimal_size: int,
    inlier_threshold: float,
    n_hypotheses: int = 256,
    min_inliers: int = 4,
    minimal_sets: torch.Tensor | None = None,
) -> RansacResult:
    """Run vectorized RANSAC over masked correspondence tensors.

    Args:
      generator: the draws' generator (unused when `minimal_sets` is given).
      data1, data2: (N, D...) corresponding measurements, on one device.
      mask: (N,) bool valid-correspondence mask.
      fit_fn(d1, d2, w) -> transform (weighted fit, w (..., N)).
      err_fn(T, d1, d2) -> (..., N) squared errors.
      minimal_size: size of the minimal set.
      inlier_threshold: error threshold (in err_fn's units).
      n_hypotheses: number of hypotheses.
      min_inliers: success gate.
      minimal_sets: optional (n_hypotheses, minimal_size) index sets; when
        given, nothing is drawn.
    """
    n = data1.shape[0]
    dtype, device = data1.dtype, data1.device
    if minimal_sets is None:
        minimal_sets = _sample_minimal_sets(generator, n_hypotheses, minimal_size, mask)
    idx = minimal_sets.to(device)
    fmask = mask.to(dtype)
    w = torch.zeros((idx.shape[0], n), dtype=dtype, device=device).scatter_(1, idx, 1.0) * fmask
    hyps = fit_fn(data1, data2, w)  # (K, ...)
    _, counts, errs = _score(err_fn(hyps, data1, data2), mask, inlier_threshold)
    score = counts.to(dtype) - 1e-3 * errs / (1.0 + errs)
    T = hyps[torch.argmax(score)]

    for _ in range(2):
        inl, cnt, _ = _score(err_fn(T, data1, data2), mask, inlier_threshold)
        T_new = fit_fn(data1, data2, inl.to(dtype))
        _, cnt_new, _ = _score(err_fn(T_new, data1, data2), mask, inlier_threshold)
        T = torch.where(cnt_new >= cnt, T_new, T)
    inliers, cnt, err = _score(err_fn(T, data1, data2), mask, inlier_threshold)
    return RansacResult(T, inliers, cnt, err, cnt >= min_inliers)
