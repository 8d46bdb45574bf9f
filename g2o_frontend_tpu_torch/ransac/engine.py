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
fed in that way to hold the two packages to one another. Steps 2-5, which
the JAX package jits, are one `utils.graphs.Stage` (`_RANSAC`) taking the
drawn sets as a tensor: on the card a key (the shapes, the solver and the
thresholds) is captured at its second call and replayed after, so the
tracker's padded calls replay and a caller at exact, varying shapes
(`slam.graph_merge`) keeps no graph for a key it calls once.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..utils import graphs


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
    if minimal_sets is None:
        minimal_sets = _sample_minimal_sets(generator, n_hypotheses, minimal_size, mask)
    return _RANSAC(data1, data2, mask, minimal_sets.to(data1.device).contiguous(), fit_fn, err_fn,
                   float(inlier_threshold), int(min_inliers))


def _ransac(data1, data2, mask, idx, fit_fn, err_fn, inlier_threshold, min_inliers) -> RansacResult:
    """Steps 2-5 over the drawn index sets `idx` (K, m) on the data's
    device."""
    n = data1.shape[0]
    dtype, device = data1.dtype, data1.device
    fmask = mask.to(dtype)
    w = torch.zeros((idx.shape[0], n), dtype=dtype, device=device).scatter_(1, idx, 1.0) * fmask
    hyps = fit_fn(data1, data2, w)  # (K, ...)
    _, counts, errs = _score(err_fn(hyps, data1, data2), mask, inlier_threshold)
    score = counts.to(dtype) - 1e-3 * errs / (1.0 + errs)
    # the best hypothesis by an index tensor: indexing with a 0-dim tensor reads it on the host
    T = hyps.index_select(0, torch.argmax(score).reshape(1))[0]

    for _ in range(2):
        inl, cnt, _ = _score(err_fn(T, data1, data2), mask, inlier_threshold)
        T_new = fit_fn(data1, data2, inl.to(dtype))
        _, cnt_new, _ = _score(err_fn(T_new, data1, data2), mask, inlier_threshold)
        T = torch.where(cnt_new >= cnt, T_new, T)
    inliers, cnt, err = _score(err_fn(T, data1, data2), mask, inlier_threshold)
    return RansacResult(T, inliers, cnt, err, cnt >= min_inliers)


_RANSAC = graphs.Stage("ransac", _ransac, second_call=True)
