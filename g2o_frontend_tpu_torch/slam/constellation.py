"""Pose-free landmark constellation matching, the loop-closure *proposal*
(counterpart of ``g2o_frontend_tpu/slam/constellation.py``).

The reference separates loop-closure candidate detection from verification
(``slam/feature_tracker_closure.h:9-202``) and its graph matcher aligns
landmark patterns independent of the pose estimate
(``graph_merge/graph_matcher.h:19-66``). A pose-gated nearest-neighbour
proposal cannot see a revisit once odometry drift exceeds its gate; this
module proposes correspondences with no pose prior:

1. hypotheses from pairwise-distance consistency (host): a pair of
   landmarks in A whose separation matches a pair in B within `dist_tol`
   votes for the two rigid SE2s aligning them (direct and swapped);
2. all K hypotheses scored at once on the device (warp A, nearest
   neighbour into B, count inliers);
3. the best one refined by mutual-NN re-fit rounds, the fit on the device,
   and gated on the inlier count; survivors return explicit landmark
   pairs for the caller's merge, re-association and solve.

`ConstellationMatch.mean_sq_err` is the mean squared residual of the pairs
in m^2 (the JAX package names it ``mean_err``; the value is the same).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..graph.store import _cap
from ..ransac import solvers as rsolvers
from ..utils import graphs


def _score_hypotheses_body(T, A, a_mask, B, b_mask, thr2):
    """Inlier count and mean NN squared error for K SE2 hypotheses at once.

    T: (K, 3) charts mapping A into B's frame; A: (NA, 2); B: (NB, 2).
    Returns (counts (K,), mean_err (K,)).
    """
    c, s = torch.cos(T[:, 2]), torch.sin(T[:, 2])
    wx = c[:, None] * A[None, :, 0] - s[:, None] * A[None, :, 1] + T[:, None, 0]  # (K, NA)
    wy = s[:, None] * A[None, :, 0] + c[:, None] * A[None, :, 1] + T[:, None, 1]
    d2 = (wx[:, :, None] - B[None, None, :, 0]) ** 2 + (wy[:, :, None] - B[None, None, :, 1]) ** 2
    d2 = torch.where(b_mask[None, None, :], d2, 1e12)
    nn = d2.min(2).values  # (K, NA)
    inl = (nn < thr2) & a_mask[None, :]
    cnt = inl.sum(1)
    err = torch.where(inl, nn, 0.0).sum(1) / torch.clamp_min(cnt, 1)
    return cnt, err


# the JAX package's jitted scoring, captured once per key (padded shapes) on the card
_score_hypotheses = graphs.Stage("score_hypotheses", _score_hypotheses_body)


@dataclass
class ConstellationMatch:
    transform: np.ndarray  # (3,) SE2 chart mapping A into B's frame
    pairs: list  # [(idx_a, idx_b)] mutual-NN inliers under the transform
    n_inliers: int
    mean_sq_err: float  # mean squared residual of the pairs, m^2
    ok: bool


def _se2_apply_np(x, pts):
    c, s = np.cos(x[2]), np.sin(x[2])
    R = np.array([[c, -s], [s, c]], np.float64)
    return pts @ R.T + x[:2]


def _mutual_nn_pairs(WA, B, thr):
    """Mutual-NN pairs between warped A and B within `thr` meters."""
    d2 = np.sum((WA[:, None] - B[None, :]) ** 2, -1)
    nn_a = d2.argmin(1)
    nn_b = d2.argmin(0)
    pairs = []
    for ia in range(len(WA)):
        ib = nn_a[ia]
        if nn_b[ib] == ia and d2[ia, ib] < thr * thr:
            pairs.append((ia, int(ib)))
    return pairs


def match_constellations(
    A,
    B,
    *,
    dist_tol: float = 0.3,
    inlier_threshold: float = 1.0,
    min_inliers: int = 6,
    min_pair_sep: float = 2.0,
    max_pair_sep: float = 40.0,
    max_hypotheses: int = 4096,
    trans_gate: float | None = None,
    rot_gate: float | None = None,
    prior: np.ndarray | None = None,
    seed: int = 0,
    device="cuda",
) -> ConstellationMatch:
    """Rigidly match 2D landmark constellation A onto B with no pose prior.

    A, B: (nA, 2) / (nB, 2) landmark positions, each internally consistent
    (e.g. rebuilt from one trajectory segment's own observations). Returns
    the SE2 aligning A into B's frame plus the mutual-NN correspondence
    pairs, gated on `min_inliers` supporting landmarks. The hypotheses are
    scored, and the refinement fits run, on `device`.

    `trans_gate` / `rot_gate` optionally bound the hypothesis space around
    `prior` (the identity by default): when A and B live in one drifted
    world frame, the true aligning transform is bounded by the odometry
    drift between the two traversals, and the gate prunes the plausible
    but impossible alignments of a quasi-regular landmark pattern.
    """
    A = np.asarray(A, np.float64).reshape(-1, 2)
    B = np.asarray(B, np.float64).reshape(-1, 2)
    nA, nB = len(A), len(B)
    fail = ConstellationMatch(np.zeros(3), [], 0, 0.0, False)
    if nA < min_inliers or nB < min_inliers:
        return fail

    # --- hypothesis generation: distance-consistent pairs (host) ---------
    def _pairs_with_sep(P):
        iu, ju = np.triu_indices(len(P), k=1)
        d = np.linalg.norm(P[iu] - P[ju], axis=1)
        keep = (d > min_pair_sep) & (d < max_pair_sep)
        return iu[keep], ju[keep], d[keep]

    ai, aj, da = _pairs_with_sep(A)
    bi, bj, db = _pairs_with_sep(B)
    if len(da) == 0 or len(db) == 0:
        return fail
    order = np.argsort(db)
    db_s, bi_s, bj_s = db[order], bi[order], bj[order]
    lo = np.searchsorted(db_s, da - dist_tol)
    hi = np.searchsorted(db_s, da + dist_tol)
    counts = hi - lo
    total = int(counts.sum())
    if total == 0:
        return fail
    # flatten the (a-pair, b-pair) match list
    a_rep = np.repeat(np.arange(len(da)), counts)
    b_idx = np.concatenate([np.arange(l, h) for l, h in zip(lo, hi) if h > l])
    if total > max_hypotheses // 2:
        rng = np.random.default_rng(seed)
        sel = rng.choice(total, max_hypotheses // 2, replace=False)
        a_rep, b_idx = a_rep[sel], b_idx[sel]

    # each distance match -> 2 hypotheses (direct + swapped assignment)
    a1 = np.concatenate([ai[a_rep], ai[a_rep]])
    a2 = np.concatenate([aj[a_rep], aj[a_rep]])
    b1 = np.concatenate([bi_s[b_idx], bj_s[b_idx]])
    b2 = np.concatenate([bj_s[b_idx], bi_s[b_idx]])
    va = A[a2] - A[a1]
    vb = B[b2] - B[b1]
    th = np.arctan2(vb[:, 1], vb[:, 0]) - np.arctan2(va[:, 1], va[:, 0])
    c, s = np.cos(th), np.sin(th)
    tx = B[b1, 0] - (c * A[a1, 0] - s * A[a1, 1])
    ty = B[b1, 1] - (s * A[a1, 0] + c * A[a1, 1])
    T = np.stack([tx, ty, th], 1).astype(np.float32)

    # drift-prior gate: `prior` is the expected transform (the identity
    # when A and B share a drifted world frame; the predicted robot pose
    # when A is one frame's robot-frame observations and B the map)
    p = np.zeros(3) if prior is None else np.asarray(prior, np.float64)
    if trans_gate is not None or rot_gate is not None:
        keep = np.ones(len(T), bool)
        if trans_gate is not None:
            keep &= np.hypot(tx - p[0], ty - p[1]) < trans_gate
        if rot_gate is not None:
            dth = (th - p[2] + np.pi) % (2 * np.pi) - np.pi
            keep &= np.abs(dth) < rot_gate
        T = T[keep]
        if len(T) == 0:
            return fail

    # --- batched scoring (device, padded shapes) --------------------------
    # K, NA and NB pad to powers of two as in the JAX package, so that the
    # stage sees few keys: the padded hypotheses are parked far away and
    # the padded points masked
    dev = torch.device(device)
    K = len(T)
    KC, NA, NB = _cap(K, 64), _cap(nA), _cap(nB)
    T_pad = np.zeros((KC, 3), np.float32)
    T_pad[:K] = T
    T_pad[K:, :2] = 1e6
    A_pad = np.zeros((NA, 2), np.float32)
    A_pad[:nA] = A
    B_pad = np.zeros((NB, 2), np.float32)
    B_pad[:nB] = B
    cnt, err = _score_hypotheses(
        torch.as_tensor(T_pad, device=dev),
        torch.as_tensor(A_pad, device=dev),
        torch.as_tensor(np.arange(NA) < nA, device=dev),
        torch.as_tensor(B_pad, device=dev),
        torch.as_tensor(np.arange(NB) < nB, device=dev),
        float(np.float32(inlier_threshold**2)),
    )
    scores = torch.stack([cnt.to(torch.float32), err])[:, :K].cpu().numpy()
    cnt, err = scores[0].astype(np.int64), scores[1]
    best = int(np.argmax(cnt.astype(np.float64) - 1e-3 * err / (1.0 + err)))
    if cnt[best] < min_inliers:
        return fail

    # --- refinement: mutual-NN re-fit rounds ------------------------------
    Tb = T[best].astype(np.float64)
    A32 = torch.as_tensor(A, dtype=torch.float32, device=dev)
    pairs = []
    for _ in range(3):
        WA = _se2_apply_np(Tb, A)
        pairs = _mutual_nn_pairs(WA, B, inlier_threshold)
        if len(pairs) < min_inliers:
            return fail
        ia = np.array([p[0] for p in pairs])
        ib = np.array([p[1] for p in pairs])
        w = np.zeros(nA, np.float32)
        w[ia] = 1.0
        tgt = np.zeros((nA, 2), np.float32)
        tgt[ia] = B[ib]
        Tb = rsolvers.fit_se2_points(torch.as_tensor(tgt, device=dev), A32,
                                     torch.as_tensor(w, device=dev)).cpu().numpy().astype(np.float64)
    WA = _se2_apply_np(Tb, A)
    pairs = _mutual_nn_pairs(WA, B, inlier_threshold)
    if len(pairs) < min_inliers:
        return fail
    if trans_gate is not None and np.hypot(Tb[0] - p[0], Tb[1] - p[1]) > trans_gate:
        return fail
    if rot_gate is not None and abs((Tb[2] - p[2] + np.pi) % (2 * np.pi) - np.pi) > rot_gate:
        return fail
    resid = [float(np.sum((WA[ia] - B[ib]) ** 2)) for ia, ib in pairs]
    return ConstellationMatch(
        transform=Tb.astype(np.float32),
        pairs=pairs,
        n_inliers=len(pairs),
        mean_sq_err=float(np.mean(resid)),
        ok=True,
    )


def segment_constellations(poses, obs_edges, lm_alive, segment: int):
    """Per-segment landmark constellations rebuilt from the segment's own
    observations (FrameClusterer role, ``feature_tracker_closure.h:105``).

    Each landmark's position inside a segment is the mean of pose ⊕ z over
    that segment's observation edges: locally rigid under drift, because a
    `segment`-pose stretch accumulates little relative error even when the
    global estimate is tens of meters off.

    Returns [(lm_ids (M,), positions (M, 2))] per segment (possibly empty).
    """
    poses = np.asarray(poses, np.float64)
    n = len(poses)
    out = []
    for s0 in range(0, n, segment):
        s1 = min(s0 + segment, n)
        acc: dict[int, list] = {}
        for (p, l, z, _w) in obs_edges:
            if s0 <= p < s1 and lm_alive[l]:
                acc.setdefault(int(l), []).append(_se2_apply_np(poses[p], np.asarray(z, np.float64)[None])[0])
        if acc:
            ids = np.array(sorted(acc), np.int64)
            pos = np.stack([np.mean(acc[int(l)], 0) for l in ids])
            out.append((ids, pos))
        else:
            out.append((np.zeros(0, np.int64), np.zeros((0, 2))))
    return out
