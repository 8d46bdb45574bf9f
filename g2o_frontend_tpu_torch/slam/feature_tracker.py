"""2D landmark SLAM with unknown data association (counterpart of
``g2o_frontend_tpu/slam/feature_tracker.py``).

Re-design of the reference feature-tracker stack
(``slam/feature_tracker.h:326-430``; main loop ``slam/tracker_test.cpp:155``):

- the map is a flat-array `PoseGraph2D` built from host lists and padded,
  as the JAX package pads it, to power-of-two capacities (at least the
  config's `reserve_*` fields): the solvers then see a handful of shapes
  over a whole run, and each shape's CUDA graphs are captured once
  (`utils.graphs`); the sliding window is a subgraph of fixed capacity;
- per-frame data association runs on `device`: an (O, L) distance matrix
  between world-predicted observations and landmark estimates, gated
  mutual-nearest-neighbour assignment, then vectorized RANSAC
  (`ransac.engine` with the Horn2D solver) to reject wrong matches and
  correct the predicted pose (``feature_tracker_pointxy.h:13-133``). The
  observations stay padded to `_cap` buckets as in the JAX package,
  so the (K, O) hypothesis draws have the same shapes in both;
- landmark lifecycle follows ``MapperState::updateTracksAndLandmarks``
  (``feature_tracker.h:340-393``): unmatched observations become pending
  tracks, promoted after `min_landmark_creation_frames` sightings;
- a sliding-window optimization every `optimize_each_n` frames, global
  optimization by the 2D backend's solvers (`optimize_se2`,
  `optimize_se2_schur`, or the float64 host `control_optimize_se2`);
- loop closing and duplicate merging (``feature_tracker_closure.h``): the
  RANSAC sweeps `close_loops` / `close_loops_global`, the pose-free
  constellation proposals, EM re-association, the covariance-gated merge.

Host Python orchestrates, as the reference's main loop does; each frame
reads the association once and the RANSAC verdict once (one stacked copy).
The functions the JAX package jits (`_associate_nn`,
`_associate_nn_mahal`, the RANSAC of ``ransac/engine.py``) are
`utils.graphs.Stage`s: on the card each key (the padded bucket shapes) is
captured once and replayed.

Every RANSAC draw goes through `FeatureTracker2D._minimal_sets`: a CPU
`torch.Generator` seeded from `config.seed`, so the card and the CPU draw
the same hypotheses. The JAX package draws from ``jax.random``, which
torch cannot reproduce; tests replace the method to feed the JAX draws.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..graph.store import PoseGraph2D, _cap, _edge_arrays, _pad, _padded_edges, _tensors
from ..ransac import solvers as rsolvers
from ..ransac.engine import _sample_minimal_sets, ransac
from ..utils import graphs

# ---------------------------------------------------------------------------
# device kernels
# ---------------------------------------------------------------------------


def _mutual_nn(d2, obs_mask, accept):
    """Mutual nearest neighbours of a masked (O, L) distance matrix:
    (match_idx (O,) landmark index or -1, best distance (O,))."""
    nn_of_obs = torch.argmin(d2, dim=1)
    nn_of_lm = torch.argmin(d2, dim=0)
    best = d2.gather(1, nn_of_obs[:, None])[:, 0]
    mutual = nn_of_lm[nn_of_obs] == torch.arange(d2.shape[0], device=d2.device)
    ok = mutual & accept(best) & obs_mask
    return torch.where(ok, nn_of_obs, -1), best


def _associate_nn_body(obs_world, obs_mask, lms, lm_mask, gate):
    """Gated mutual-NN assignment between observations and landmarks.

    Returns (match_idx (O,) landmark index or -1, dists (O,)).
    """
    d2 = ((obs_world[:, None, :] - lms[None, :, :]) ** 2).sum(-1)
    d2 = torch.where(obs_mask[:, None] & lm_mask[None, :], d2, 1e12)
    return _mutual_nn(d2, obs_mask, lambda best: best < gate * gate)


def _associate_nn_mahal_body(obs_world, obs_mask, lms, lm_mask, Sinv, chi2_gate, eucl_cap):
    """Mahalanobis-gated mutual-NN assignment.

    ``Sinv[l]`` is the inverse of landmark l's association covariance
    ``S_l = C_ll + R + sigma_drift^2 I``; the distance
    ``(o - l)^T Sinv_l (o - l)`` is tested against a chi-square(2) gate, so
    a duplicate meters away along its drift direction gates in while a
    distinct nearby landmark with a tight covariance gates out. `eucl_cap`
    bounds the search radius in meters.
    """
    diff = obs_world[:, None, :] - lms[None, :, :]
    d2m = torch.einsum("olj,ljk,olk->ol", diff, Sinv, diff)
    d2e = (diff * diff).sum(-1)
    valid = obs_mask[:, None] & lm_mask[None, :] & (d2e < eucl_cap * eucl_cap)
    d2m = torch.where(valid, d2m, 1e12)
    return _mutual_nn(d2m, obs_mask, lambda best: best < chi2_gate)


# the JAX package's jitted association kernels, captured once per key on the card
_associate_nn = graphs.Stage("associate_nn", _associate_nn_body)
_associate_nn_mahal = graphs.Stage("associate_nn_mahal", _associate_nn_mahal_body)


def _ransac_verify(minimal_sets, obs_local, lm_world, pairs_mask, thresh):
    """RANSAC over tentative pairs: the robot pose x with
    lm_world ~ x ⊕ obs_local, and the inlier mask."""
    return ransac(
        None,
        lm_world,
        obs_local,
        pairs_mask,
        fit_fn=rsolvers.fit_se2_points,
        err_fn=rsolvers.err_se2_points,
        minimal_size=2,
        inlier_threshold=thresh * thresh,
        n_hypotheses=128,
        min_inliers=2,
        minimal_sets=minimal_sets,
    )


# ---------------------------------------------------------------------------
# tracker
# ---------------------------------------------------------------------------


@dataclass
class Tracker2DConfig:
    """Parameter names mirror the ``tracker_test.cpp:185-214`` flags."""

    min_landmark_creation_frames: int = 2
    incremental_ransac_inlier_threshold: float = 0.5
    incremental_guess_max_feature_distance: float = 1.0
    loop_ransac_inlier_threshold: float = 0.2
    loop_guess_max_feature_distance: float = 2.0
    loop_landmark_merge_distance: float = 0.5
    local_map_size: int = 10
    optimize_each_n: int = 10
    local_optimize_iters: int = 3
    global_optimize_iters: int = 15
    # "pcg" (online default) | "schur" (offline polish) | "control" (float64
    # host LM, exact)
    global_solver: str = "pcg"
    # robust (Huber) kernel width in whitened-residual units for global
    # optimization; None = quadratic
    huber_delta: float | None = None
    cg_iters: int = 60
    local_cg_iters: int = 30
    odom_info: tuple = (100.0, 100.0, 1000.0)
    obs_default_info: float = 300.0
    # -odometryIsGood (tracker_test.cpp:187): RANSAC validates
    # correspondences and never overrides the predicted pose
    odometry_is_good: bool = False
    # Mahalanobis incremental association, once refresh_landmark_
    # covariances() has run: chi-square gate on C_ll + R + sigma_drift^2 I,
    # sigma_drift growing per frame since the refresh up to its cap;
    # mahal_eucl_cap bounds the search radius in meters
    mahal_chi2_gate: float = 9.21  # chi2(2) 99%
    mahal_drift_sigma: float = 0.05  # m / frame since last refresh
    mahal_drift_cap: float = 1.5
    mahal_eucl_cap: float = 10.0
    # per-frame relocalization closure (LoopClosureCandidateDetector +
    # FrameClusterer, ``feature_tracker_closure.h:9-202``): a frame's
    # observation set is matched pose-free against the old map within a
    # drift-budget radius; two consecutive frames must imply the same
    # world correction before it is accepted
    frame_closure: bool = False
    closure_min_obs: int = 5
    closure_old_age: int = 150  # frames unseen before a landmark is "old"
    closure_drift_base: float = 10.0  # m, search radius floor
    closure_drift_rate: float = 0.05  # m per frame since last localization
    closure_drift_cap: float = 100.0
    closure_rot_gate: float = 1.2  # rad, hypothesis gate around prediction
    closure_dist_tol: float = 0.4
    closure_inlier_threshold: float = 1.0
    closure_min_inliers: int = 5
    closure_cluster_tol: float = 3.0  # consecutive-proposal agreement (m)
    closure_cluster_rot_tol: float = 0.15
    # minimum capacities of the padded global graph (`graph()`): reserving
    # the final size up front gives the solvers one shape for a whole run
    reserve_poses: int = 0
    reserve_landmarks: int = 0
    reserve_odom_edges: int = 0
    reserve_obs_edges: int = 0
    seed: int = 0


def _se2_compose_np(a, b):
    c, s = np.cos(a[2]), np.sin(a[2])
    return np.array(
        [a[0] + c * b[0] - s * b[1],
         a[1] + s * b[0] + c * b[1],
         (a[2] + b[2] + np.pi) % (2 * np.pi) - np.pi],
        np.float32,
    )


def _se2_rel_np(a, b):
    """SE2 relative chart a^{-1} b (float64 in, float64 out)."""
    c, s = np.cos(a[2]), np.sin(a[2])
    d = b[:2] - a[:2]
    dth = (b[2] - a[2] + np.pi) % (2 * np.pi) - np.pi
    return np.array([c * d[0] + s * d[1], -s * d[0] + c * d[1], dth], np.float64)


def _se2_apply_np(x, pts):
    c, s = np.cos(x[2]), np.sin(x[2])
    R = np.array([[c, -s], [s, c]], np.float32)
    return pts @ R.T + x[:2]


def _pose_graph(poses, landmarks, landmark_mask, odo, obs, fixed, caps, device) -> PoseGraph2D:
    """A PoseGraph2D on `device` from host arrays and edge lists [(i, j, z,
    info)] (indices already into `poses` / `landmarks`), padded as the JAX
    package pads it to `caps` = (poses, landmarks, pose-pose edges,
    pose-landmark edges) rows: padded rows are zero, masked off and not
    fixed (`graph.store._pad`, `_padded_edges`)."""
    NP, NL, EP, EL = caps
    n, nl = len(poses), len(landmarks)
    return _tensors(PoseGraph2D, dict(
        poses=_pad(np.asarray(poses, np.float32).reshape(n, 3), NP), pose_mask=np.arange(NP) < n,
        landmarks=_pad(np.asarray(landmarks, np.float32).reshape(nl, 2), NL),
        landmark_mask=_pad(np.asarray(landmark_mask, bool), NL),
        **_padded_edges("pp", _edge_arrays(odo, 3), EP), **_padded_edges("pl", _edge_arrays(obs, 2), EL),
        fixed=_pad(np.asarray(fixed, bool), NP)), torch.float32, device)


class FeatureTracker2D:
    """Incremental 2D landmark SLAM over a growing flat-array graph; the
    association, RANSAC and solves run on `device`."""

    def __init__(self, config: Tracker2DConfig = Tracker2DConfig(), device="cuda"):
        self.cfg = config
        self.device = torch.device(device)
        # CPU generator: the same hypotheses whichever device scores them
        self.generator = torch.Generator().manual_seed(config.seed)
        # growing host-side state
        self.poses: list[np.ndarray] = []  # [x, y, th]
        self.landmarks = np.zeros((0, 2), np.float32)
        self.lm_alive = np.zeros(0, bool)
        self.lm_seen = np.zeros(0, np.int32)
        self.odom_edges: list[tuple[int, int, np.ndarray, np.ndarray]] = []
        self.obs_edges: list[tuple[int, int, np.ndarray, np.ndarray]] = []
        # pending tracks: pos (world), count, history [(pose_idx, local_xy, info)]
        self.pending: list[dict] = []
        self.frame = 0
        # per-landmark 2x2 marginal covariances for Mahalanobis association
        # (None until refresh_landmark_covariances() runs)
        self.lm_cov: np.ndarray | None = None
        self._cov_frame = 0  # frame at last covariance refresh
        # per-frame relocalization state
        self.lm_last_seen = np.zeros(0, np.int32)
        self._drift_frames = 0  # frames since last accepted relocalization
        self._pending_closure: tuple | None = None  # (frame, world corr)
        self.n_relocalizations = 0  # accepted frame-closure count

    def _minimal_sets(self, n_hyp: int, m: int, mask) -> torch.Tensor:
        """(n_hyp, m) RANSAC index sets over the host mask (N,): every draw
        of the tracker goes through here."""
        return _sample_minimal_sets(self.generator, n_hyp, m, torch.as_tensor(mask))

    def _t(self, a):
        return torch.as_tensor(a, device=self.device)

    # -- graph snapshot -----------------------------------------------------
    def _graph(self, window_fix_before, device) -> PoseGraph2D:
        cfg = self.cfg
        n = len(self.poses)
        fixed = np.zeros(n, bool)
        fixed[:1] = True
        if window_fix_before is not None:
            fixed[: min(window_fix_before, n)] = True
        caps = (_cap(max(n, 1, cfg.reserve_poses)), _cap(max(len(self.landmarks), 1, cfg.reserve_landmarks)),
                _cap(max(len(self.odom_edges), 1, cfg.reserve_odom_edges)),
                _cap(max(len(self.obs_edges), 1, cfg.reserve_obs_edges)))
        return _pose_graph(self.poses, self.landmarks, self.lm_alive, self.odom_edges, self.obs_edges, fixed, caps,
                           device)

    def graph(self, window_fix_before: int | None = None) -> PoseGraph2D:
        """A PoseGraph2D snapshot on the tracker's device, padded to the
        capacity buckets (optionally freezing the poses before
        `window_fix_before`)."""
        return self._graph(window_fix_before, self.device)

    def _sync_from_graph(self, g):
        n = len(self.poses)
        nl = len(self.landmarks)
        poses = g.poses[:n].cpu().numpy()
        for i in range(n):
            self.poses[i] = poses[i]
        if nl:
            self.landmarks = g.landmarks[:nl].cpu().numpy().copy()

    # -- main entry ---------------------------------------------------------
    def process_frame(self, odom_delta, obs_local, obs_info=None):
        """Ingest one frame.

        Args:
          odom_delta: (3,) relative odometry from the previous pose
            (ignored for the first frame; pass zeros).
          obs_local: (O, 2) feature observations in the robot frame.
          obs_info: optional (O, 2, 2) information matrices.
        Returns the (O,) landmark index matched to each observation, or -1.
        """
        cfg = self.cfg
        obs_local = np.asarray(obs_local, np.float32).reshape(-1, 2)
        O = len(obs_local)
        if obs_info is None:
            obs_info = np.tile(np.eye(2, dtype=np.float32) * cfg.obs_default_info, (O, 1, 1))

        # 1. pose prediction
        if not self.poses:
            pose = np.zeros(3, np.float32)
            self.poses.append(pose)
        else:
            prev = self.poses[-1]
            pose = _se2_compose_np(np.asarray(prev, np.float32), np.asarray(odom_delta, np.float32))
            self.poses.append(pose)
            info = np.diag(np.asarray(cfg.odom_info, np.float32))
            self.odom_edges.append((len(self.poses) - 2, len(self.poses) - 1, np.asarray(odom_delta, np.float32),
                                    info))
        pose_idx = len(self.poses) - 1

        # 2a. per-frame relocalization (drift-tolerant closure proposal)
        forced: dict[int, int] = {}
        self._drift_frames += 1
        if cfg.frame_closure and O >= cfg.closure_min_obs and self.lm_alive.any():
            reloc = self._propose_frame_closure(pose, obs_local)
            if reloc is not None:
                pose, forced = reloc
                self.poses[-1] = pose

        matched_lm = np.full(O, -1, np.int64)
        if O and self.lm_alive.any():
            matched_lm = self._associate(pose, obs_local)
        for oi, li in forced.items():
            matched_lm[oi] = li

        # 3. record observation edges for matches
        for oi in range(O):
            li = matched_lm[oi]
            if li >= 0:
                self.obs_edges.append((pose_idx, int(li), obs_local[oi], obs_info[oi]))
                self.lm_seen[li] += 1
                self.lm_last_seen[li] = self.frame

        # 4. pending-track management for unmatched observations
        self._update_pending(pose, pose_idx, obs_local, obs_info, matched_lm)

        # 5. periodic local optimization
        self.frame += 1
        if cfg.optimize_each_n and self.frame % cfg.optimize_each_n == 0:
            self.optimize(local=True)

        return matched_lm

    # -- per-frame relocalization ------------------------------------------
    def _propose_frame_closure(self, pose_pred, obs_local):
        """Match this frame's observation constellation (robot frame, rigid
        by construction) against the old map, pose-free.

        Returns (corrected_pose (3,), {obs_idx: landmark_idx}) when two
        consecutive eligible frames imply the same world correction
        (FrameClusterer acceptance), else None.
        """
        from .constellation import match_constellations

        cfg = self.cfg
        R = min(cfg.closure_drift_base + cfg.closure_drift_rate * self._drift_frames, cfg.closure_drift_cap)
        old = np.where(self.lm_alive & (self.frame - self.lm_last_seen > cfg.closure_old_age))[0]
        if len(old) < cfg.closure_min_inliers:
            return None
        sense_r = float(np.linalg.norm(obs_local, axis=1).max())
        d = np.linalg.norm(self.landmarks[old] - np.asarray(pose_pred[:2]), axis=1)
        B_idx = old[d < R + sense_r + 5.0]
        if len(B_idx) < cfg.closure_min_inliers:
            return None
        m = match_constellations(
            obs_local,
            self.landmarks[B_idx],
            dist_tol=cfg.closure_dist_tol,
            inlier_threshold=cfg.closure_inlier_threshold,
            min_inliers=cfg.closure_min_inliers,
            min_pair_sep=1.0,
            max_pair_sep=2.0 * sense_r + 1.0,
            trans_gate=R,
            rot_gate=cfg.closure_rot_gate,
            prior=np.asarray(pose_pred, np.float64),
            seed=self.frame,
            device=self.device,
        )
        if not m.ok:
            return None
        T = np.asarray(m.transform, np.float32)
        corr = np.array([T[0] - pose_pred[0], T[1] - pose_pred[1],
                         (T[2] - pose_pred[2] + np.pi) % (2 * np.pi) - np.pi], np.float64)
        prev = self._pending_closure
        self._pending_closure = (self.frame, corr)
        if prev is None or self.frame - prev[0] > 3:
            return None
        dcorr = corr - prev[1]
        if (np.hypot(dcorr[0], dcorr[1]) > cfg.closure_cluster_tol
                or abs((dcorr[2] + np.pi) % (2 * np.pi) - np.pi) > cfg.closure_cluster_rot_tol):
            return None
        self._pending_closure = None
        self._drift_frames = 0
        self.n_relocalizations += 1
        pairs = {int(ia): int(B_idx[ib]) for ia, ib in m.pairs}
        return T, pairs

    def propose_window_closure(self, window=60, dist_tol=0.4, inlier_threshold=1.0, min_inliers=6, old_age=150,
                               drift_base=10.0, drift_rate=0.05, drift_cap=100.0, rot_gate=1.2, apply=True):
        """Drift-tolerant online closure: match the recent window's
        constellation against the old map, pose-free, and merge matches.

        The matching unit is the observation set of the last `window`
        poses, played against landmarks unseen for `old_age` frames within
        a drift-budget radius (`drift_base + drift_rate *
        frames_since_localized`, at most `drift_cap`), with the hypothesis
        space gated around the identity by that budget. Callers should
        follow an accepted merge with a validated solve and roll back on a
        chi2 jump (`validated_slam`).

        With `apply` the pairs are merged and the count of merged pairs is
        returned (0 when nothing matched). Without it nothing changes: the
        match comes back as a dict of `pairs`, `transform` and
        `window_start`, and every failure returns None (the JAX package
        returns 0 from its early exits there).
        """
        from .constellation import match_constellations

        fail = 0 if apply else None
        n = len(self.poses)
        start = max(0, n - window)
        acc: dict[int, list] = {}
        for (p, l, z, _w) in self.obs_edges:
            if p >= start and self.lm_alive[l]:
                acc.setdefault(int(l), []).append(
                    _se2_apply_np(np.asarray(self.poses[p], np.float32), np.asarray(z, np.float32)[None])[0])
        if len(acc) < min_inliers:
            return fail
        ids_a = np.array(sorted(acc), np.int64)
        pos_a = np.stack([np.mean(acc[int(l)], 0) for l in ids_a])
        R = min(drift_base + drift_rate * self._drift_frames, drift_cap)
        in_window = set(ids_a.tolist())
        old = np.array([l for l in np.where(self.lm_alive)[0]
                        if l not in in_window and self.frame - int(self.lm_last_seen[l]) > old_age], np.int64)
        if len(old) < min_inliers:
            return fail
        centroid = pos_a.mean(0)
        span = float(np.linalg.norm(pos_a - centroid, axis=1).max())
        d = np.linalg.norm(self.landmarks[old] - centroid, axis=1)
        B_idx = old[d < R + span + 5.0]
        if len(B_idx) < min_inliers:
            return fail
        m = match_constellations(
            pos_a,
            self.landmarks[B_idx],
            dist_tol=dist_tol,
            inlier_threshold=inlier_threshold,
            min_inliers=min_inliers,
            min_pair_sep=1.0,
            max_pair_sep=2.0 * span + 5.0,
            trans_gate=R,
            rot_gate=rot_gate,
            seed=self.frame,
            device=self.device,
        )
        if not m.ok:
            return fail
        pairs = [
            (int(ids_a[ia]), int(B_idx[ib]))
            for ia, ib in m.pairs
            if int(ids_a[ia]) != int(B_idx[ib]) and self.lm_alive[int(ids_a[ia])] and self.lm_alive[int(B_idx[ib])]
        ]
        if not apply:
            # the transform and window range let the absorber warp the
            # trajectory into the closure's basin before solving
            return {"pairs": pairs, "transform": np.asarray(m.transform, np.float64), "window_start": start}
        merged = 0
        for la, lb in pairs:
            if self.lm_alive[la] and self.lm_alive[lb]:
                self._merge_landmarks(lb, la)  # keep the old landmark
                merged += 1
        if merged:
            self.n_relocalizations += 1
        return merged

    def obs_edge_chi2(self):
        """Per-observation-edge chi2 at the current estimate (E,)."""
        if not self.obs_edges:
            return np.zeros(0)
        poses = np.asarray(self.poses, np.float64)
        E = len(self.obs_edges)
        P = np.fromiter((e[0] for e in self.obs_edges), np.int64, E)
        Li = np.fromiter((e[1] for e in self.obs_edges), np.int64, E)
        Z = np.stack([np.asarray(e[2], np.float64) for e in self.obs_edges])
        Wm = np.stack([np.asarray(e[3], np.float64) for e in self.obs_edges])
        c, s = np.cos(poses[P, 2]), np.sin(poses[P, 2])
        dd = self.landmarks[Li].astype(np.float64) - poses[P, :2]
        e = np.stack([c * dd[:, 0] + s * dd[:, 1], -s * dd[:, 0] + c * dd[:, 1]], 1) - Z
        return np.einsum("ki,kij,kj->k", e, Wm, e)

    # -- association --------------------------------------------------------
    def _associate(self, pose, obs_local):
        """Gated NN + RANSAC association on the device. Observations pad to
        a power-of-two bucket and landmarks to their capacity, as in the
        JAX package, so that its RANSAC draws fit these shapes."""
        cfg = self.cfg
        O = len(obs_local)
        OC = _cap(max(O, 1))
        L = len(self.landmarks)
        LC = _cap(max(L, 1))
        obs_world = _se2_apply_np(np.asarray(pose, np.float32), obs_local)
        obs_pad = np.zeros((OC, 2), np.float32)
        obs_pad[:O] = obs_world
        obs_mask = np.arange(OC) < O
        lms_pad = np.zeros((LC, 2), np.float32)
        lms_pad[:L] = self.landmarks
        alive_pad = np.zeros(LC, bool)
        alive_pad[:L] = self.lm_alive
        if self.lm_cov is not None:
            # Mahalanobis gate: S_l = C_ll + R + sigma_drift^2 I, the drift
            # term growing since the last covariance refresh; R from the
            # observation information
            sig2 = min(cfg.mahal_drift_sigma * max(self.frame - self._cov_frame, 1), cfg.mahal_drift_cap) ** 2
            r2 = 1.0 / max(float(cfg.obs_default_info), 1e-6)
            S = np.tile((r2 + sig2) * np.eye(2, dtype=np.float32), (LC, 1, 1))
            ncov = min(len(self.lm_cov), L)
            S[:ncov] += self.lm_cov[:ncov]
            det = S[:, 0, 0] * S[:, 1, 1] - S[:, 0, 1] * S[:, 1, 0]
            det = np.maximum(det, 1e-12)
            Sinv = np.empty_like(S)
            Sinv[:, 0, 0] = S[:, 1, 1] / det
            Sinv[:, 1, 1] = S[:, 0, 0] / det
            Sinv[:, 0, 1] = -S[:, 0, 1] / det
            Sinv[:, 1, 0] = -S[:, 1, 0] / det
            m_idx, _ = _associate_nn_mahal(self._t(obs_pad), self._t(obs_mask), self._t(lms_pad),
                                           self._t(alive_pad), self._t(Sinv), cfg.mahal_chi2_gate,
                                           cfg.mahal_eucl_cap)
        else:
            m_idx, _ = _associate_nn(self._t(obs_pad), self._t(obs_mask), self._t(lms_pad), self._t(alive_pad),
                                     cfg.incremental_guess_max_feature_distance)
        m_idx = m_idx[:O].cpu().numpy()
        pairs = m_idx >= 0
        if pairs.sum() < 3:
            return np.where(pairs, m_idx, -1)

        # RANSAC verification of the tentative set (+ pose correction)
        lm_w = np.zeros((OC, 2), np.float32)
        lm_w[:O][pairs] = self.landmarks[m_idx[pairs]]
        obs_local_pad = np.zeros((OC, 2), np.float32)
        obs_local_pad[:O] = obs_local
        pairs_pad = np.zeros(OC, bool)
        pairs_pad[:O] = pairs
        res = _ransac_verify(self._minimal_sets(128, 2, pairs_pad), self._t(obs_local_pad), self._t(lm_w),
                             self._t(pairs_pad), cfg.incremental_ransac_inlier_threshold)
        # one read: the transform (3), ok, the inlier mask
        out = torch.cat([res.transform, res.ok[None].float(), res.inliers[:O].float()]).cpu().numpy()
        if not out[3]:
            return np.full(O, -1, np.int64)
        inl = out[4:] > 0
        if not cfg.odometry_is_good:
            # corrected pose from the RANSAC transform
            self.poses[-1] = out[:3].copy()
        return np.where(pairs & inl, m_idx, -1)

    # -- landmark lifecycle -------------------------------------------------
    def _update_pending(self, pose, pose_idx, obs_local, obs_info, matched_lm):
        cfg = self.cfg
        obs_world = (_se2_apply_np(np.asarray(pose, np.float32), obs_local)
                     if len(obs_local) else np.zeros((0, 2), np.float32))
        unmatched = [oi for oi in range(len(obs_local)) if matched_lm[oi] < 0]
        used = set()
        # match pending tracks by NN
        for p in self.pending:
            best, bd = -1, cfg.incremental_guess_max_feature_distance**2
            for oi in unmatched:
                if oi in used:
                    continue
                d = float(np.sum((obs_world[oi] - p["pos"]) ** 2))
                if d < bd:
                    best, bd = oi, d
            if best >= 0:
                used.add(best)
                p["count"] += 1
                p["pos"] = 0.5 * (p["pos"] + obs_world[best])
                p["hist"].append((pose_idx, obs_local[best], obs_info[best]))
            else:
                p["count"] = -1  # lost -> drop
        self.pending = [p for p in self.pending if p["count"] >= 0]

        # promote mature tracks
        promoted = []
        for p in self.pending:
            if p["count"] + 1 >= max(cfg.min_landmark_creation_frames, 1):
                li = len(self.landmarks)
                self.landmarks = np.vstack([self.landmarks, p["pos"][None].astype(np.float32)])
                self.lm_alive = np.append(self.lm_alive, True)
                self.lm_seen = np.append(self.lm_seen, len(p["hist"]))
                self.lm_last_seen = np.append(self.lm_last_seen, np.int32(self.frame))
                for (pi, z, w) in p["hist"]:
                    self.obs_edges.append((pi, li, z, w))
                promoted.append(id(p))
        self.pending = [p for p in self.pending if id(p) not in promoted]

        # new tracks for remaining unmatched
        for oi in unmatched:
            if oi in used:
                continue
            self.pending.append({"pos": obs_world[oi].copy(), "count": 0,
                                 "hist": [(pose_idx, obs_local[oi], obs_info[oi])]})

    # -- optimization -------------------------------------------------------
    def optimize(self, local=False, iters=None):
        """Window (`local`) or global optimization; returns the final chi2.

        The global solver is `cfg.global_solver`: "pcg" (`optimize_se2`),
        "schur" (`optimize_se2_schur`) or "control" (the float64 host
        `control_optimize_se2`, exact; it reads a host copy of the graph,
        built once)."""
        if local:
            return self._optimize_window()
        cfg = self.cfg
        iters = cfg.global_optimize_iters if iters is None else iters
        if cfg.global_solver == "control":
            from ..solvers.control import control_optimize_se2

            ctl = control_optimize_se2(self._graph(None, "cpu"), max_iters=iters)
            for i in range(len(self.poses)):
                self.poses[i] = np.asarray(ctl["poses"][i], np.float32)
            nl = len(self.landmarks)
            if nl:
                self.landmarks = np.asarray(ctl["landmarks"][:nl], np.float32)
            return float(ctl["chi2"])
        g = self.graph()
        if cfg.global_solver == "schur":
            from ..solvers.schur_pcg import optimize_se2_schur

            g_opt, stats = optimize_se2_schur(g, iters=iters, cg_iters=cfg.cg_iters, huber_delta=cfg.huber_delta)
        else:
            from ..solvers.pose_graph import optimize_se2

            g_opt, stats = optimize_se2(g, iters=iters, cg_iters=cfg.cg_iters, huber_delta=cfg.huber_delta)
        self._sync_from_graph(g_opt)
        return float(stats.chi2[-1])

    def refresh_landmark_covariances(self):
        """Recompute the per-landmark 2x2 marginal covariances from the
        current graph (`landmark_covariance_se2`, the reference's
        computeMarginals role) and reset the drift clock; `_associate` then
        gates by Mahalanobis distance."""
        from ..solvers.schur_pcg import landmark_covariance_se2

        nl = len(self.landmarks)
        if nl == 0 or not self.lm_alive.any():
            return
        cov = landmark_covariance_se2(self.graph())  # (NL, 2, NL, 2), NL the landmark capacity
        self.lm_cov = cov.diagonal(dim1=0, dim2=2).permute(2, 0, 1)[:nl].cpu().numpy().astype(np.float32)
        self._cov_frame = self.frame

    def _optimize_window(self):
        """Local optimization over the sliding window (the
        `OptimizationManager` local map of ``feature_tracker_closure.h``) as
        a subgraph of fixed capacity: the last `local_map_size` poses and
        the landmarks they observe, padded to power-of-two buckets as the
        JAX package pads them, so that the solver sees a handful of shapes
        over a whole run; landmarks observed before the window stay fixed."""
        from ..solvers.pose_graph import optimize_se2

        cfg = self.cfg
        n = len(self.poses)
        W = min(cfg.local_map_size, n)
        if W < 2:
            return 0.0
        start = n - W
        odo = [(i - start, j - start, z, w) for (i, j, z, w) in self.odom_edges if i >= start]
        obs = [(p, l, z, w) for (p, l, z, w) in self.obs_edges if p >= start]
        lm_ids = sorted({l for (_, l, _, _) in obs})
        lmap = {l: k for k, l in enumerate(lm_ids)}
        seen_before = {l for (p, l, _, _) in self.obs_edges if p < start}
        lm_free = np.array([l not in seen_before for l in lm_ids], bool)
        fixed = np.zeros(W, bool)
        fixed[0] = True  # gauge: anchor the window's first pose
        caps = (_cap(cfg.local_map_size), _cap(max(len(lm_ids), 1)), _cap(max(len(odo), 1)),
                _cap(max(len(obs), 1)))
        g = _pose_graph(self.poses[start:], self.landmarks[lm_ids], lm_free, odo,
                        [(p - start, lmap[l], z, w) for (p, l, z, w) in obs], fixed, caps, self.device)
        g_opt, stats = optimize_se2(g, iters=cfg.local_optimize_iters, cg_iters=cfg.local_cg_iters)
        out = torch.cat([g_opt.poses[:W].flatten(), g_opt.landmarks[: len(lm_ids)].flatten(),
                         stats.chi2[-1:]]).cpu().numpy()
        new_poses = out[: 3 * W].reshape(W, 3)
        for k in range(W):
            self.poses[start + k] = new_poses[k]
        new_lms = out[3 * W:-1].reshape(-1, 2)
        for l in lm_ids:
            if lm_free[lmap[l]]:
                self.landmarks[l] = new_lms[lmap[l]]
        return float(out[-1])

    # -- loop closing -------------------------------------------------------
    def close_loops(self):
        """RANSAC-match recent landmarks against older ones; merge accepted.

        Landmarks observed from the current window against the rest, gated
        NN + RANSAC (``feature_tracker_closure.h``); accepted pairs are
        merged (edges re-targeted). Returns the number merged.
        """
        cfg = self.cfg
        nl = len(self.landmarks)
        if nl < 8:
            return 0
        window_start = max(0, len(self.poses) - cfg.local_map_size)
        recent_set = {l for (p, l, _, _) in self.obs_edges if p >= window_start}
        recent = np.array(sorted(recent_set), np.int64)
        old = np.array([l for l in range(nl) if self.lm_alive[l] and l not in recent_set], np.int64)
        if len(recent) < 3 or len(old) < 3:
            return 0
        RC = _cap(len(recent))
        OC = _cap(len(old))
        rec_pad = np.zeros((RC, 2), np.float32)
        rec_pad[: len(recent)] = self.landmarks[recent]
        rec_mask = np.arange(RC) < len(recent)
        old_pad = np.zeros((OC, 2), np.float32)
        old_pad[: len(old)] = self.landmarks[old]
        old_mask = np.arange(OC) < len(old)
        m_idx, _ = _associate_nn(self._t(rec_pad), self._t(rec_mask), self._t(old_pad), self._t(old_mask),
                                 cfg.loop_guess_max_feature_distance)
        m_idx = m_idx[: len(recent)].cpu().numpy()
        pairs = m_idx >= 0
        if pairs.sum() < 3:
            return 0
        tgt = np.zeros((RC, 2), np.float32)
        tgt[: len(recent)][pairs] = self.landmarks[old[m_idx[pairs]]]
        pairs_pad = np.zeros(RC, bool)
        pairs_pad[: len(recent)] = pairs
        res = ransac(None, self._t(tgt), self._t(rec_pad), self._t(pairs_pad), fit_fn=rsolvers.fit_se2_points,
                     err_fn=rsolvers.err_se2_points, minimal_size=2,
                     inlier_threshold=cfg.loop_ransac_inlier_threshold**2, n_hypotheses=256, min_inliers=3,
                     minimal_sets=self._minimal_sets(256, 2, pairs_pad))
        out = torch.cat([res.ok[None], res.inliers[: len(recent)]]).cpu().numpy()
        if not out[0]:
            return 0
        inl = out[1:]
        merged = 0
        for k in range(len(recent)):
            if pairs[k] and inl[k]:
                keep = int(old[m_idx[k]])
                drop = int(recent[k])
                if keep == drop or not self.lm_alive[drop]:
                    continue
                self._merge_landmarks(keep, drop)
                merged += 1
        return merged

    def close_loops_global(self, segment=200, gate=4.0, inlier_threshold=0.3):
        """Whole-trajectory closure sweep: merge drift-separated duplicates.

        For every `segment`-pose stretch, RANSAC-fit an SE2 from that
        segment's landmarks to all non-segment landmarks within `gate`
        meters, require the consensus to cover a quarter of the segment's
        candidate landmarks (at least 4), re-match every segment landmark
        through the fitted SE2 and merge those within `inlier_threshold`
        (the reference's batch closure after ``tracker_test.cpp``'s final
        optimize). Returns the number of merged landmark pairs.
        """
        merged_total = 0
        n = len(self.poses)
        nl = len(self.landmarks)
        if nl < 8:
            return 0
        for s0 in range(0, n, segment):
            window = set(range(s0, min(s0 + segment, n)))
            seg_set = {l for (p, l, _, _) in self.obs_edges if p in window and self.lm_alive[l]}
            other = [l for l in range(nl) if self.lm_alive[l] and l not in seg_set]
            seg_l = np.array(sorted(seg_set), np.int64)
            if len(seg_l) < 3 or len(other) < 3:
                continue
            L_seg = self.landmarks[seg_l]
            L_oth = self.landmarks[np.array(other)]
            d2 = np.sum((L_seg[:, None] - L_oth[None, :]) ** 2, -1)
            # candidate pairs: all (segment, other) pairs within the gate
            si, oi = np.nonzero(d2 < gate * gate)
            if len(si) < 3:
                continue
            RC = _cap(len(si))
            src = np.zeros((RC, 2), np.float32)
            src[: len(si)] = L_seg[si]
            tgt = np.zeros((RC, 2), np.float32)
            tgt[: len(si)] = L_oth[oi]
            pm = np.zeros(RC, bool)
            pm[: len(si)] = True
            res = ransac(None, self._t(tgt), self._t(src), self._t(pm), fit_fn=rsolvers.fit_se2_points,
                         err_fn=rsolvers.err_se2_points, minimal_size=2, inlier_threshold=inlier_threshold**2,
                         n_hypotheses=256, min_inliers=4, minimal_sets=self._minimal_sets(256, 2, pm))
            out = torch.cat([res.transform, res.ok[None].float(), res.n_inliers[None].float()]).cpu().numpy()
            if not out[3]:
                continue
            # consensus gate: a fit supported by a handful of landmarks is a
            # spurious alignment
            n_inl = int(out[4])  # the padded entries are masked out
            n_src = len(set(si.tolist()))
            if n_inl < max(4, 0.25 * n_src):
                continue
            # re-match all segment landmarks through the fitted SE2
            warped = _se2_apply_np(out[:3], L_seg)
            d2w = np.sum((warped[:, None] - L_oth[None, :]) ** 2, -1)
            jw = np.argmin(d2w, 1)
            dw = d2w[np.arange(len(seg_l)), jw]
            for k in range(len(seg_l)):
                if dw[k] < inlier_threshold * inlier_threshold:
                    keep = int(other[jw[k]])
                    drop = int(seg_l[k])
                    if keep != drop and self.lm_alive[drop] and self.lm_alive[keep]:
                        self._merge_landmarks(keep, drop)
                        merged_total += 1
        return merged_total

    def close_loops_constellation(self, segment=250, dist_tol=0.3, inlier_threshold=1.0, min_inliers=6,
                                  min_pair_sep=2.0, max_pair_sep=40.0, require_anchor_ratio=0.0):
        """Drift-tolerant loop-closure proposal by constellation matching.

        The trajectory is cut into `segment`-pose stretches, each rebuilt
        from its own observations (locally rigid under drift), and every
        pair of segments is matched pose-free (``graph_merge/
        graph_matcher.h:19-66``). Accepted matches merge their landmark
        pairs; callers should `reassociate` + `optimize` afterwards.
        `require_anchor_ratio` > 0 also demands that a share of the
        supporting pairs are already-shared landmarks. Returns the number
        of merged landmark pairs.
        """
        from .constellation import match_constellations, segment_constellations

        segs = segment_constellations(self.poses, self.obs_edges, self.lm_alive, segment)
        merged = 0
        for j in range(len(segs)):
            ids_a, pos_a = segs[j]
            if len(ids_a) < min_inliers:
                continue
            for i in range(j):
                ids_b, pos_b = segs[i]
                if len(ids_b) < min_inliers:
                    continue
                m = match_constellations(pos_a, pos_b, dist_tol=dist_tol, inlier_threshold=inlier_threshold,
                                         min_inliers=min_inliers, min_pair_sep=min_pair_sep,
                                         max_pair_sep=max_pair_sep, seed=i * 10007 + j, device=self.device)
                if not m.ok:
                    continue
                new_pairs = [(int(ids_a[ia]), int(ids_b[ib])) for ia, ib in m.pairs if int(ids_a[ia]) != int(ids_b[ib])]
                n_anchor = m.n_inliers - len(new_pairs)
                if not new_pairs:
                    continue
                if require_anchor_ratio > 0.0 and n_anchor < require_anchor_ratio * m.n_inliers:
                    continue
                for la, lb in new_pairs:
                    if la != lb and self.lm_alive[la] and self.lm_alive[lb]:
                        # keep the earlier-created landmark
                        keep, drop = (lb, la) if lb < la else (la, lb)
                        self._merge_landmarks(keep, drop)
                        merged += 1
        return merged

    def close_loops_hierarchical(self, segment=250, dist_tol=0.3, inlier_threshold=1.0, min_inliers=6,
                                 min_pair_sep=2.0, max_pair_sep=40.0, coarse_iters=100, odom_info=(0.1, 0.1, 1.0),
                                 closure_info=(25.0, 25.0, 100.0)):
        """Constellation proposal + coarse-to-fine drift absorption.

        Every accepted constellation match becomes a segment-level SE2
        closure edge; the coarse pose graph (one anchor per segment) is
        solved exactly in float64 on the host, each segment is rigidly
        warped by its anchor's correction, landmarks are re-anchored from
        the corrected poses, and only then are the matched pairs merged:
        the fine solver starts inside the right basin (the hierarchical
        layers of ``map_core.h``). Returns the number of merged landmark
        pairs (0 = no accepted match).
        """
        from ..solvers.control import control_optimize_se2
        from .constellation import match_constellations, segment_constellations

        segs = segment_constellations(self.poses, self.obs_edges, self.lm_alive, segment)
        S = len(segs)
        n = len(self.poses)
        if S < 2:
            return 0
        matches = []  # (i, j, T_world, [(lm_a, lm_b)])
        for j in range(S):
            ids_a, pos_a = segs[j]
            if len(ids_a) < min_inliers:
                continue
            for i in range(j):
                ids_b, pos_b = segs[i]
                if len(ids_b) < min_inliers:
                    continue
                m = match_constellations(pos_a, pos_b, dist_tol=dist_tol, inlier_threshold=inlier_threshold,
                                         min_inliers=min_inliers, min_pair_sep=min_pair_sep,
                                         max_pair_sep=max_pair_sep, seed=i * 10007 + j, device=self.device)
                if not m.ok:
                    continue
                pairs = [(int(ids_a[ia]), int(ids_b[ib])) for ia, ib in m.pairs]
                matches.append((i, j, np.asarray(m.transform, np.float64), pairs))
        if sum(1 for (_, _, _, ps) in matches for (a, b) in ps if a != b) == 0:
            return 0

        # --- coarse segment pose graph (float64 exact solve) -----------
        anchors = [min(s0 * segment, n - 1) for s0 in range(S)]
        X_old = np.asarray([self.poses[a] for a in anchors], np.float64)
        w_odo = np.diag(np.asarray(odom_info, np.float64))
        w_cls = np.diag(np.asarray(closure_info, np.float64))
        edges = [(s, s + 1, _se2_rel_np(X_old[s], X_old[s + 1]), w_odo) for s in range(S - 1)]
        for (i, j, T, _pairs) in matches:
            if i == j:
                continue
            aj_corr = _se2_compose_np(T.astype(np.float32), X_old[j].astype(np.float32))
            edges.append((i, j, _se2_rel_np(X_old[i], aj_corr.astype(np.float64)), w_cls))
        fixed = np.zeros(S, bool)
        fixed[0] = True
        gc = _pose_graph(X_old, np.zeros((0, 2)), np.zeros(0, bool), edges, [], fixed, (S, 1, len(edges), 1), "cpu")
        ctl = control_optimize_se2(gc, max_iters=coarse_iters)
        X_new = np.asarray(ctl["poses"], np.float64)[:S]

        # --- rigid per-segment warp of the level-0 trajectory -----------
        for s in range(S):
            lo = s * segment
            hi = min(lo + segment, n)
            for p in range(lo, hi):
                local = _se2_rel_np(X_old[s], np.asarray(self.poses[p], np.float64))
                self.poses[p] = _se2_compose_np(X_new[s].astype(np.float32), local.astype(np.float32))

        # --- re-anchor landmarks from the corrected poses ---------------
        poses_np = np.asarray(self.poses, np.float32)
        acc = np.zeros((len(self.landmarks), 2), np.float64)
        cnt = np.zeros(len(self.landmarks), np.int64)
        for (p, l, z, _w) in self.obs_edges:
            acc[l] += _se2_apply_np(poses_np[p], np.asarray(z, np.float32)[None])[0]
            cnt[l] += 1
        upd = (cnt > 0) & self.lm_alive
        self.landmarks[upd] = (acc[upd] / cnt[upd, None]).astype(np.float32)

        # --- merge the matched landmark pairs ---------------------------
        merged = 0
        for (_i, _j, _T, pairs) in matches:
            for la, lb in pairs:
                if la != lb and self.lm_alive[la] and self.lm_alive[lb]:
                    keep, drop = (lb, la) if lb < la else (la, lb)
                    self._merge_landmarks(keep, drop)
                    merged += 1
        return merged

    def reassociate(self, gate=1.0):
        """EM re-association: re-target each observation edge to the nearest
        alive landmark (within `gate` m) under the current pose estimates,
        killing landmarks left with no observations (the reference's
        `LandmarkCorrespondenceManager` re-binding). The expectation step to
        `optimize()`'s maximization. Returns the number of re-targeted
        edges."""
        poses = np.asarray(self.poses, np.float64)
        alive = np.where(self.lm_alive)[0]
        if len(alive) == 0 or not self.obs_edges:
            return 0
        L = self.landmarks[alive].astype(np.float64)
        E = len(self.obs_edges)
        P = np.fromiter((e[0] for e in self.obs_edges), np.int64, E)
        Z = np.stack([np.asarray(e[2], np.float64) for e in self.obs_edges])
        cur = np.fromiter((e[1] for e in self.obs_edges), np.int64, E)
        c, s = np.cos(poses[P, 2]), np.sin(poses[P, 2])
        W = np.stack([poses[P, 0] + c * Z[:, 0] - s * Z[:, 1], poses[P, 1] + s * Z[:, 0] + c * Z[:, 1]], 1)
        # chunked NN (an E x L distance matrix can be hundreds of MB)
        tgt = np.empty(E, np.int64)
        ok = np.empty(E, bool)
        g2 = gate * gate
        step = max(1, int(4e6 // max(len(L), 1)))
        for a in range(0, E, step):
            b = min(a + step, E)
            d2 = np.sum((W[a:b, None] - L[None]) ** 2, -1)
            j = d2.argmin(1)
            tgt[a:b] = alive[j]
            ok[a:b] = d2[np.arange(b - a), j] < g2
        move = ok & (tgt != cur)
        moved = int(move.sum())
        if moved:
            for k in np.where(move)[0]:
                p, _l, z, w = self.obs_edges[k]
                self.obs_edges[k] = (p, int(tgt[k]), z, w)
        final = np.where(move, tgt, cur)
        counts = np.bincount(final, minlength=len(self.landmarks))
        self.lm_alive[alive[counts[alive] == 0]] = False
        return moved

    def merge_landmarks_mahalanobis(self, chi2_gate=9.21, prefilter_distance=8.0):
        """Covariance-gated duplicate merge (the principled version of
        ``loopLandmarkMergeDistance``'s Euclidean gate).

        Two estimates are duplicates when
        ``d2 = diff^T (C_ll + C_mm - C_lm - C_ml)^-1 diff`` passes a
        chi-square(2) gate; the joint covariances come from
        `landmark_covariance_se2` on the device. Merges go best-first with a
        union guard; callers should re-run `optimize` + `reassociate`.
        Returns the number of merged pairs.
        """
        from ..solvers.schur_pcg import landmark_covariance_se2

        alive = np.where(self.lm_alive)[0]
        if len(alive) < 2:
            return 0
        nl = len(self.landmarks)
        cov = landmark_covariance_se2(self.graph())[:nl, :, :nl].cpu().numpy()  # (nl, 2, nl, 2)
        P = self.landmarks[alive]
        d2 = np.sum((P[:, None] - P[None, :]) ** 2, -1)
        iu, ju = np.triu_indices(len(alive), k=1)
        near = d2[iu, ju] < prefilter_distance * prefilter_distance
        cand = []
        for a, b in zip(iu[near], ju[near]):
            l, m = int(alive[a]), int(alive[b])
            diff = P[a] - P[b]
            S = cov[l, :, l, :] + cov[m, :, m, :] - cov[l, :, m, :] - cov[m, :, l, :]
            det = S[0, 0] * S[1, 1] - S[0, 1] * S[1, 0]
            if det <= 1e-12 or S[0, 0] <= 0:
                continue
            Sinv = np.array([[S[1, 1], -S[0, 1]], [-S[1, 0], S[0, 0]]]) / det
            m2 = float(diff @ Sinv @ diff)
            if m2 < chi2_gate:
                cand.append((m2, l, m))
        merged = 0
        gone = set()
        for m2, l, m in sorted(cand):
            if l in gone or m in gone:
                continue
            # keep the better-observed landmark
            keep, drop = (l, m) if self.lm_seen[l] >= self.lm_seen[m] else (m, l)
            self._merge_landmarks(keep, drop)
            gone.add(drop)
            merged += 1
        return merged

    def split_inconsistent_landmarks(self, spread_gate=4.0, cluster_eps=2.5):
        """Split chimera landmarks (wrong merges) back apart.

        A landmark whose observations, projected through the current poses,
        form several well-separated clusters (single linkage at
        `cluster_eps`, spread over `spread_gate`) fuses distinct physical
        landmarks; each non-dominant cluster's edges move to a fresh
        landmark. Returns the number of new landmarks created.
        """
        poses = np.asarray(self.poses, np.float32)
        by_lm: dict[int, list] = {}
        for k, (p, l, z, _w) in enumerate(self.obs_edges):
            if self.lm_alive[l]:
                by_lm.setdefault(int(l), []).append(k)
        created = 0
        for l, idxs in by_lm.items():
            if len(idxs) < 2:
                continue
            pts = np.stack([
                _se2_apply_np(poses[self.obs_edges[k][0]], np.asarray(self.obs_edges[k][2], np.float32)[None])[0]
                for k in idxs
            ])
            d = np.linalg.norm(pts - pts.mean(0), axis=1)
            if d.max() < spread_gate:
                continue
            m = len(idxs)
            parent = list(range(m))

            def find(a):
                while parent[a] != a:
                    parent[a] = parent[parent[a]]
                    a = parent[a]
                return a

            d2 = np.sum((pts[:, None] - pts[None, :]) ** 2, -1)
            for a in range(m):
                for b in range(a + 1, m):
                    if d2[a, b] < cluster_eps * cluster_eps:
                        ra, rb = find(a), find(b)
                        if ra != rb:
                            parent[rb] = ra
            roots: dict[int, list] = {}
            for a in range(m):
                roots.setdefault(find(a), []).append(a)
            if len(roots) < 2:
                continue
            clusters = sorted(roots.values(), key=len, reverse=True)
            # the dominant cluster keeps the landmark; the others split off
            self.landmarks[l] = pts[clusters[0]].mean(0)
            self.lm_seen[l] = len(clusters[0])
            for cl in clusters[1:]:
                li = len(self.landmarks)
                self.landmarks = np.vstack([self.landmarks, pts[cl].mean(0)[None]])
                self.lm_alive = np.append(self.lm_alive, True)
                self.lm_seen = np.append(self.lm_seen, len(cl))
                self.lm_last_seen = np.append(self.lm_last_seen,
                                              np.int32(max(self.obs_edges[idxs[a]][0] for a in cl)))
                for a in cl:
                    k = idxs[a]
                    p, _l, z, w = self.obs_edges[k]
                    self.obs_edges[k] = (p, li, z, w)
                created += 1
        return created

    def cull_weak_landmarks(self, min_obs=2):
        """Drop landmarks supported by fewer than `min_obs` observations,
        and their observation edges (the reference's track-length
        threshold, ``feature_tracker.h:340-393``). Returns the number
        culled."""
        counts = np.zeros(len(self.landmarks), np.int64)
        for (_, l, _, _) in self.obs_edges:
            counts[l] += 1
        weak = {l for l in np.where(self.lm_alive)[0] if counts[l] < min_obs}
        if not weak:
            return 0
        self.obs_edges = [e for e in self.obs_edges if e[1] not in weak]
        for l in weak:
            self.lm_alive[l] = False
        return len(weak)

    def merge_nearby_landmarks(self, distance=None):
        """Post-optimization duplicate merge (loopLandmarkMergeDistance)."""
        d = distance or self.cfg.loop_landmark_merge_distance
        nl = len(self.landmarks)
        if nl < 2:
            return 0
        alive_idx = np.where(self.lm_alive)[0]
        P = self.landmarks[alive_idx]
        d2 = np.sum((P[:, None] - P[None, :]) ** 2, -1)
        np.fill_diagonal(d2, 1e12)
        merged = 0
        done = set()
        for a in range(len(alive_idx)):
            if a in done:
                continue
            b = int(np.argmin(d2[a]))
            if d2[a, b] < d * d and b not in done:
                self._merge_landmarks(int(alive_idx[a]), int(alive_idx[b]))
                done.add(b)
                merged += 1
        return merged

    def _merge_landmarks(self, keep: int, drop: int):
        for k, (p, l, z, w) in enumerate(self.obs_edges):
            if l == drop:
                self.obs_edges[k] = (p, keep, z, w)
        self.lm_seen[keep] += self.lm_seen[drop]
        if len(self.lm_last_seen) > max(keep, drop):
            self.lm_last_seen[keep] = max(self.lm_last_seen[keep], self.lm_last_seen[drop])
        self.lm_alive[drop] = False

    # -- state snapshot / restore (closure-validation rollback) -------------
    def snapshot(self):
        """Copy of the mutable map state, for validated-closure rollback."""
        return (
            [np.asarray(p).copy() for p in self.poses],
            self.landmarks.copy(),
            self.lm_alive.copy(),
            self.lm_seen.copy(),
            list(self.obs_edges),
            self.lm_last_seen.copy(),
        )

    def restore(self, snap):
        (poses, lms, alive, seen, obs, last_seen) = snap
        self.poses = [p.copy() for p in poses]
        self.landmarks = lms.copy()
        self.lm_alive = alive.copy()
        self.lm_seen = seen.copy()
        self.obs_edges = list(obs)
        self.lm_last_seen = last_seen.copy()

    # -- results ------------------------------------------------------------
    def trajectory(self):
        return np.asarray(self.poses)

    def stats(self):
        return {
            "n_poses": len(self.poses),
            "n_landmarks": int(self.lm_alive.sum()),
            "n_obs_edges": len(self.obs_edges),
            "n_odom_edges": len(self.odom_edges),
            "n_pending": len(self.pending),
        }
