"""Partitioned-state distributed SE2 and SE3 pose-graph optimization
(counterpart of ``g2o_frontend_tpu/parallel/partitioned_pose_graph.py``).

Poses are block-partitioned across the mesh, NOT replicated, together
with their Hessian diagonal blocks, per-edge linearizations and all CG
state. Each shard owns:

- a contiguous block of B = ceil(NP/D) poses (trajectory order, so chain
  edges stay shard-local),
- the edges whose lower endpoint falls in its block, with endpoints
  re-encoded as local slots: [0, B) = own poses, [B, B+G) = ghost slots for
  remote endpoints (loop closures, block-boundary odometry),
- the ghost directory: the global pose ids of its G ghost slots.

Each CG matvec moves only the boundary blocks the ghost directories name
(`halo.py`) and scatter-adds the ghosts' contributions back into their
owners; landmarks are owned by the block that observes them most and
exchanged the same way. Per-device bytes are O(ghosts) per direction.

The partition (`partition_se2`, `partition_se3`, `partition_stats`,
`comm_volume`) is the JAX package's host code, copied. The solvers run on
a mesh (`mesh.py`): on a `StackedMesh` the S shards' local graphs are one
flattened graph, each shard's slots offset into its own range, so that the
single-device linearization and scatter-adds (`solvers/pose_graph.py`)
give each shard's local sums.
"""
from __future__ import annotations

import dataclasses
import types
from typing import NamedTuple

import numpy as np
import torch

from ..graph.store import PoseGraph2D, PoseGraph3D
from ..solvers import pose_graph as pg
from ..solvers.pcg import pcg
from ..solvers.tridiag import cr_factor, cr_solve
from ..utils import lie
from .halo import (HaloSpec, build_halo_spec, halo_bytes_per_exchange, halo_collectives_per_exchange, halo_gather,
                   halo_reduce)
from .mesh import offset_pairs
from .sharded_pose_graph import shard_chi2
from .spike import spike_factor, spike_solve

PRECONDITIONERS_SE2 = ("jacobi", "chain")
PRECONDITIONERS_SE3 = ("jacobi", "spike")


def _host(g):
    """A graph's fields as numpy arrays on the host."""
    return types.SimpleNamespace(**{f.name: getattr(g, f.name).detach().cpu().numpy() for f in dataclasses.fields(g)})


class PartitionedSE2(NamedTuple):
    """Host-built shard-stacked problem; leading dim D on sharded arrays."""

    poses_blk: np.ndarray  # (D, B, 3)
    free_p_blk: np.ndarray  # (D, B) f32
    ghost_ids: np.ndarray  # (D, G) int32 global pose ids (0-padded)
    pp_ij: np.ndarray  # (D, E, 2) int32 LOCAL slot ids (own < B, ghost >= B)
    pp_meas: np.ndarray  # (D, E, 3)
    pp_info: np.ndarray  # (D, E, 3, 3)
    pp_mask: np.ndarray  # (D, E) bool
    pp_chain: np.ndarray  # (D, E) bool: block-INTERNAL consecutive odometry
    pp_bnd: np.ndarray  # (D, E) bool: the right-BOUNDARY consecutive edge
    # (global i = lo+B-1 -> j = lo+B; feeds the SPIKE interface coupling)
    pl_ij: np.ndarray  # (D, EL, 2) int32 (local pose slot, LOCAL lm slot)
    pl_meas: np.ndarray  # (D, EL, 2)
    pl_info: np.ndarray  # (D, EL, 2, 2)
    pl_mask: np.ndarray  # (D, EL) bool
    lms_blk: np.ndarray  # (D, BL, 2) landmark blocks — sharded, NOT replicated
    free_l_blk: np.ndarray  # (D, BL) f32
    lm_ghost_ids: np.ndarray  # (D, GL) int32 global landmark ids (0-padded)
    lm_gid: np.ndarray  # (D, BL+GL) int32 global lm id per local slot
    # (own slots then ghost slots; padding slots 0 — only reached by edges
    # whose mask already zeroes their weight)
    n_poses: int  # true NP (before block padding)
    n_landmarks: int  # true NL
    lm_owner: np.ndarray  # (NL,) int32 owning device per landmark
    lm_local: np.ndarray  # (NL,) int32 owner-local slot per landmark
    halo: HaloSpec  # pose-block exchange schedule (parallel/halo.py)
    halo_l: HaloSpec  # landmark-block exchange schedule


def partition_se2(g: PoseGraph2D, n_dev: int,
                  halo_mode: str = "auto") -> PartitionedSE2:
    """Block-partition a PoseGraph2D over n_dev shards (host-side).

    halo_mode picks the exchange wire format (parallel/halo.py): "ppermute"
    minimizes bytes, "a2a" minimizes collective launches, "auto" trades off.
    """
    g = _host(g)
    poses = np.asarray(g.poses)
    pose_mask = np.asarray(g.pose_mask)
    fixed = np.asarray(g.fixed)
    NP = int(pose_mask.sum())
    B = -(-NP // n_dev)
    NPp = B * n_dev

    pp_ij = np.asarray(g.pp_ij)
    pp_mask = np.asarray(g.pp_mask)
    pl_ij = np.asarray(g.pl_ij)
    pl_mask = np.asarray(g.pl_mask)

    def shard_of(p):
        return p // B

    # bucket edges by owner = shard of the lower endpoint
    own_pp = [[] for _ in range(n_dev)]
    for k in np.where(pp_mask)[0]:
        own_pp[shard_of(min(pp_ij[k, 0], pp_ij[k, 1]))].append(k)
    own_pl = [[] for _ in range(n_dev)]
    for k in np.where(pl_mask)[0]:
        own_pl[shard_of(pl_ij[k, 0])].append(k)

    E = max(8, max((len(b) for b in own_pp), default=0))
    EL = max(8, max((len(b) for b in own_pl), default=0))

    # ghost directory per shard
    ghosts = []
    for s in range(n_dev):
        lo, hi = s * B, (s + 1) * B
        gset = set()
        for k in own_pp[s]:
            for p in pp_ij[k]:
                if not (lo <= p < hi):
                    gset.add(int(p))
        for k in own_pl[s]:
            p = pl_ij[k, 0]
            if not (lo <= p < hi):
                gset.add(int(p))
        ghosts.append(sorted(gset))
    G = max(8, max((len(gl) for gl in ghosts), default=0))

    # landmark blocks + ghost directory. Each landmark is OWNED by the pose
    # block that observes it most (the reference groups landmarks with their
    # submaps the same way — ``boss_map/map_utils.cpp:167`` partitions carry
    # their local features); only landmarks co-observed across blocks
    # (revisits / loop closures) become ghosts — O(boundary), not O(NL).
    NL = g.landmarks.shape[0]
    obs_count = np.zeros((NL, n_dev), np.int64)
    for s in range(n_dev):
        for k in own_pl[s]:
            obs_count[pl_ij[k, 1], s] += 1
    observed = obs_count.sum(axis=1) > 0
    lm_owner = np.where(
        observed, obs_count.argmax(axis=1), np.arange(NL) % n_dev
    ).astype(np.int32)
    owned_ls = [np.where(lm_owner == s)[0] for s in range(n_dev)]
    BL = max(1, max(len(o) for o in owned_ls))
    lm_local = np.zeros(NL, np.int32)
    for s in range(n_dev):
        lm_local[owned_ls[s]] = np.arange(len(owned_ls[s]))
    lm_ghosts = []
    for s in range(n_dev):
        lset = {
            int(pl_ij[k, 1])
            for k in own_pl[s]
            if lm_owner[pl_ij[k, 1]] != s
        }
        lm_ghosts.append(sorted(lset))
    GL = max(4, max((len(gl) for gl in lm_ghosts), default=0))

    poses_blk = np.zeros((n_dev, B, 3), np.float32)
    free_p_blk = np.zeros((n_dev, B), np.float32)
    ghost_ids = np.zeros((n_dev, G), np.int32)
    pp_ij_l = np.zeros((n_dev, E, 2), np.int32)
    pp_meas_l = np.zeros((n_dev, E, 3), np.float32)
    pp_info_l = np.zeros((n_dev, E, 3, 3), np.float32)
    pp_mask_l = np.zeros((n_dev, E), bool)
    pp_chain_l = np.zeros((n_dev, E), bool)
    pp_bnd_l = np.zeros((n_dev, E), bool)
    pl_ij_l = np.zeros((n_dev, EL, 2), np.int32)
    pl_meas_l = np.zeros((n_dev, EL, 2), np.float32)
    pl_info_l = np.zeros((n_dev, EL, 2, 2), np.float32)
    pl_mask_l = np.zeros((n_dev, EL), bool)

    pp_meas = np.asarray(g.pp_meas)
    pp_info = np.asarray(g.pp_info)
    pl_meas = np.asarray(g.pl_meas)
    pl_info = np.asarray(g.pl_info)

    lms = np.asarray(g.landmarks, np.float32)
    lmask = np.asarray(g.landmark_mask)
    lms_blk = np.zeros((n_dev, BL, 2), np.float32)
    free_l_blk = np.zeros((n_dev, BL), np.float32)
    lm_ghost_ids = np.zeros((n_dev, GL), np.int32)
    lm_gid = np.zeros((n_dev, BL + GL), np.int32)

    for s in range(n_dev):
        lo = s * B
        blk = poses[lo : lo + B]
        poses_blk[s, : len(blk)] = blk
        fm = (pose_mask & ~fixed)[lo : lo + B]
        free_p_blk[s, : len(blk)] = fm.astype(np.float32)
        gmap = {p: B + r for r, p in enumerate(ghosts[s])}
        ghost_ids[s, : len(ghosts[s])] = ghosts[s]
        mine = owned_ls[s]
        lms_blk[s, : len(mine)] = lms[mine]
        free_l_blk[s, : len(mine)] = lmask[mine].astype(np.float32)
        lgmap = {l: BL + r for r, l in enumerate(lm_ghosts[s])}
        lm_ghost_ids[s, : len(lm_ghosts[s])] = lm_ghosts[s]
        lm_gid[s, : len(mine)] = mine
        lm_gid[s, BL : BL + len(lm_ghosts[s])] = lm_ghosts[s]

        def loc(p):
            return p - lo if lo <= p < lo + B else gmap[int(p)]

        def loc_l(l):
            return lm_local[l] if lm_owner[l] == s else lgmap[int(l)]

        for r, k in enumerate(own_pp[s]):
            pp_ij_l[s, r] = (loc(pp_ij[k, 0]), loc(pp_ij[k, 1]))
            pp_meas_l[s, r] = pp_meas[k]
            pp_info_l[s, r] = pp_info[k]
            pp_mask_l[s, r] = True
            # block-internal consecutive odometry edge (feeds the optional
            # per-device chain preconditioner; boundary edges stay out)
            pp_chain_l[s, r] = (
                pp_ij[k, 1] == pp_ij[k, 0] + 1
                and lo <= pp_ij[k, 0] < lo + B - 1
            )
            pp_bnd_l[s, r] = (
                pp_ij[k, 1] == pp_ij[k, 0] + 1 and pp_ij[k, 0] == lo + B - 1
            )
        for r, k in enumerate(own_pl[s]):
            pl_ij_l[s, r] = (loc(pl_ij[k, 0]), loc_l(pl_ij[k, 1]))
            pl_meas_l[s, r] = pl_meas[k]
            pl_info_l[s, r] = pl_info[k]
            pl_mask_l[s, r] = True

    return PartitionedSE2(
        poses_blk=poses_blk,
        free_p_blk=free_p_blk,
        ghost_ids=ghost_ids,
        pp_ij=pp_ij_l,
        pp_meas=pp_meas_l,
        pp_info=pp_info_l,
        pp_mask=pp_mask_l,
        pp_chain=pp_chain_l,
        pp_bnd=pp_bnd_l,
        pl_ij=pl_ij_l,
        pl_meas=pl_meas_l,
        pl_info=pl_info_l,
        pl_mask=pl_mask_l,
        lms_blk=lms_blk,
        free_l_blk=free_l_blk,
        lm_ghost_ids=lm_ghost_ids,
        lm_gid=lm_gid,
        n_poses=NP,
        n_landmarks=NL,
        lm_owner=lm_owner,
        lm_local=lm_local,
        halo=build_halo_spec(ghosts, B, n_dev, G, mode=halo_mode),
        halo_l=build_halo_spec(lm_ghosts, BL, n_dev, GL, mode=halo_mode,
                               owner=lm_owner, local=lm_local),
    )


def partition_stats(p: PartitionedSE2) -> dict:
    """Per-device memory accounting (bytes) vs the full-graph footprint."""
    per_dev = 0
    full = 0
    for a in [getattr(p, name) for name in
              ("poses_blk", "free_p_blk", "ghost_ids", "pp_ij", "pp_meas",
               "pp_info", "pp_mask", "pp_chain", "pp_bnd", "pl_ij", "pl_meas",
               "pl_info", "pl_mask", "lms_blk", "free_l_blk",
               "lm_ghost_ids", "lm_gid")] + [
              p.halo.send_idx, p.halo.recv_pos,
              p.halo_l.send_idx, p.halo_l.recv_pos]:
        per_dev += a.nbytes // a.shape[0]
        full += a.nbytes
    D, B = p.poses_blk.shape[0], p.poses_blk.shape[1]
    G = p.ghost_ids.shape[1]
    BL, GL = p.lms_blk.shape[1], p.lm_ghost_ids.shape[1]
    # CG state: 4 block vectors (x, r, z, p) + the B+G / BL+GL aug vectors
    # + the packed halo buffers — O(N/D + ghosts), no O(N) transient
    cg_per_dev = (4 * B + B + G + sum(p.halo.sizes)) * 3 * 4 + (
        (4 * BL + BL + GL + sum(p.halo_l.sizes)) * 2 * 4
    )
    return {
        "devices": D,
        "block_poses": B,
        "block_landmarks": BL,
        "bytes_sharded_per_device": per_dev,
        "bytes_replicated_per_device": 0,
        "bytes_full_graph": full,
        "bytes_cg_state_per_device": cg_per_dev,
    }


def comm_volume(p: PartitionedSE2, lm_iters: int, cg_matvecs: int) -> dict:
    """Per-device communication bytes for a run, from the halo schedules.

    Per CG matvec: forward halo exchanges of the pose + landmark search
    directions' boundary blocks + reverse exchanges of ghost Hv
    contributions (each O(ghosts) bytes) + 2 scalar psums (dots). Per LM
    iteration: gradient + diagonal-block halo reduces, the state halo
    gathers, and the chi2 scalar. Nothing is O(N); nothing is replicated.
    """
    halo_vec = halo_bytes_per_exchange(p.halo, 3)  # (S, 3) block vectors
    halo_diag = halo_bytes_per_exchange(p.halo, 9)  # (S, 3, 3) blocks
    halo_lvec = halo_bytes_per_exchange(p.halo_l, 2)  # (S, 2)
    halo_ldiag = halo_bytes_per_exchange(p.halo_l, 4)  # (S, 2, 2)
    per_matvec = 2 * (halo_vec + halo_lvec)
    per_lm = 3 * (halo_vec + halo_lvec) + halo_diag + halo_ldiag
    return {
        "bytes_per_matvec": per_matvec,
        "bytes_per_lm_iter": per_lm,
        "bytes_total": per_matvec * cg_matvecs + per_lm * lm_iters,
        "cg_matvecs": cg_matvecs,
        "halo_shifts": list(p.halo.shifts),
        "halo_slots": int(sum(p.halo.sizes)),
        "halo_lm_slots": int(sum(p.halo_l.sizes)),
        "halo_mode": p.halo.mode,
        "halo_lm_mode": p.halo_l.mode,
        # true boundary traffic (without wire padding): worst device's
        # received ghost slots — the information-theoretic floor
        "true_ghost_slots_max_dev": int(
            (p.halo.recv_pos < p.halo.n_ghost)
            .reshape(p.poses_blk.shape[0], -1).sum(1).max()
        ),
        "true_lm_ghost_slots_max_dev": int(
            (p.halo_l.recv_pos < p.halo_l.n_ghost)
            .reshape(p.poses_blk.shape[0], -1).sum(1).max()
        ),
        "collectives_per_matvec": 2 * (
            halo_collectives_per_exchange(p.halo)
            + halo_collectives_per_exchange(p.halo_l)
        ) + 2,
    }


class _Halo:
    """One exchange schedule on the mesh, for blocks of `n` own slots."""

    def __init__(self, spec: HaloSpec, n: int, mesh):
        self.spec, self.n, self.mesh = spec, n, mesh
        self.send, self.recv = mesh.local(spec.send_idx, torch.int64), mesh.local(spec.recv_pos, torch.int64)

    def gather_aug(self, v):
        """(S, n, ...) -> (S, n + G, ...): own blocks, then their ghosts'
        values, moved by a halo exchange of only the boundary blocks."""
        return torch.cat([v, halo_gather(v, self.send, self.recv, self.spec, self.mesh)], 1)

    def reduce(self, contrib):
        """(S, n + G, ...) -> (S, n, ...): ghost rows sent back to their
        owners and scatter-added."""
        return halo_reduce(contrib[:, :self.n], contrib[:, self.n:], self.send, self.recv, self.spec, self.mesh)


class _Shards:
    """A pose-block partition on the mesh: this program's S shards, their
    halo schedules and their local graphs flattened into one."""

    def __init__(self, part, mesh, free_next=False):
        loc = mesh.local
        self.mesh, self.part = mesh, part
        self.poses0, self.free_p = loc(part.poses_blk), loc(part.free_p_blk)
        self.S, self.B = self.poses0.shape[:2]
        self.G = part.ghost_ids.shape[1]
        self.halo = _Halo(part.halo, self.B, mesh)
        self.pp_ij, self.pp_chain, self.pp_bnd = loc(part.pp_ij, torch.int64), loc(part.pp_chain), loc(part.pp_bnd)
        if free_next:
            # the free mask of the NEXT shard's first pose (gauges the
            # boundary coupling); the fixed set does not change mid-solve
            nxt = np.zeros(mesh.size, np.float32)
            nxt[:-1] = part.free_p_blk[1:, 0]
            self.free_next0 = loc(nxt)

    def dot(self, a, b):
        """The inner product of two sharded block vectors, summed over the
        mesh: every shard reads the same value."""
        local = sum((x * y).flatten(1).sum(1) for x, y in zip(a, b))
        return self.mesh.psum(local)[0]

    def chi2(self, lin):
        c = shard_chi2(lin.e_pp, lin.w_pp, self.S)
        if lin.e_pl is not None:
            c = c + shard_chi2(lin.e_pl, lin.w_pl, self.S)
        return self.mesh.psum(c)[0]

    def segment_sum(self, values, idx, n):
        """(S * E, ...) per-edge values into each shard's n slots by local
        (S, E) indices -> (S, n, ...)."""
        return pg._segment_sum(values, self.mesh.flat_index(idx, n), self.S * n).view((self.S, n) + values.shape[1:])

    def chain_blocks(self, lin):
        """(L, U), (S, B, d, d): each shard's block-internal odometry-chain
        tridiagonal, zero where either end is fixed."""
        S, B, d = self.S, self.B, lin.Ji_pp.shape[-1]
        chain = self.pp_chain.reshape(-1)
        ci = torch.where(self.pp_chain, self.pp_ij[..., 0], B - 1)
        U = self.segment_sum(pg._jtwj(lin.Ji_pp, lin.w_pp * chain[:, None, None], lin.Jj_pp), ci, B)
        fnext = torch.cat([self.free_p[:, 1:], self.free_p.new_zeros((S, 1))], 1)
        U = U * (self.free_p * fnext)[..., None, None]
        return torch.cat([U.new_zeros((S, 1, d, d)), U.transpose(-1, -2)[:, :-1]], 1), U

    def boundary_block(self, lin):
        """(S, d, d): the coupling of each shard's last pose to the next
        shard's first, through the right-boundary odometry edge."""
        d = lin.Ji_pp.shape[-1]
        bnd = self.pp_bnd.reshape(-1)[:, None, None]
        U = pg._jtwj(lin.Ji_pp, lin.w_pp * bnd, lin.Jj_pp).view(self.S, -1, d, d).sum(1)
        return U * (self.free_p[:, self.B - 1] * self.free_next0)[:, None, None]

    def blocks_of(self, x, like):
        """The solved (S, B, ...) blocks of every shard -> the full (NP, ...)
        array of the input graph (poses past the partition kept)."""
        flat = self.mesh.gather(x).reshape((-1,) + x.shape[2:])[: like.shape[0]].to(like.device)
        return torch.cat([flat, like[flat.shape[0]:]]) if flat.shape[0] < like.shape[0] else flat


class _Shards2D(_Shards):
    """`_Shards` of a `PartitionedSE2`, with its landmark blocks."""

    def __init__(self, part: PartitionedSE2, mesh, free_next=False):
        super().__init__(part, mesh, free_next)
        loc = mesh.local
        self.lms0, self.free_l = loc(part.lms_blk), loc(part.free_l_blk)
        self.BL, self.GL = part.lms_blk.shape[1], part.lm_ghost_ids.shape[1]
        self.halo_l = _Halo(part.halo_l, self.BL, mesh)
        self.pl_ij, self.lm_gid = loc(part.pl_ij, torch.int64), loc(part.lm_gid, torch.int64)
        P, L = self.B + self.G, self.BL + self.GL
        n_pose, n_lm = self.S * P, self.S * L
        dev = self.poses0.device
        self.graph0 = PoseGraph2D(
            poses=self.poses0.new_zeros((n_pose, 3)), pose_mask=torch.ones(n_pose, dtype=torch.bool, device=dev),
            landmarks=self.lms0.new_zeros((n_lm, 2)), landmark_mask=torch.ones(n_lm, dtype=torch.bool, device=dev),
            pp_ij=offset_pairs(self.pp_ij, P, P, mesh=mesh), pp_meas=loc(part.pp_meas).flatten(0, 1),
            pp_info=loc(part.pp_info).flatten(0, 1), pp_mask=loc(part.pp_mask).flatten(0, 1),
            pl_ij=offset_pairs(self.pl_ij, P, L, mesh=mesh), pl_meas=loc(part.pl_meas).flatten(0, 1),
            pl_info=loc(part.pl_info).flatten(0, 1), pl_mask=loc(part.pl_mask).flatten(0, 1),
            fixed=torch.zeros(n_pose, dtype=torch.bool, device=dev))

    def graph(self, pb, lb):
        """The flattened local graphs at own pose and landmark blocks
        (S, B, 3) and (S, BL, 2), ghosts fetched by halo exchange."""
        return self.graph0.with_poses(self.halo.gather_aug(pb).flatten(0, 1), self.halo_l.gather_aug(lb).flatten(0, 1))

    def reduce(self, hp_aug, hl_aug):
        """Flattened (S * (B+G), 3) and (S * (BL+GL), 2) per-slot sums ->
        own (S, B, 3) and (S, BL, 2) blocks."""
        S = self.S
        return (self.halo.reduce(hp_aug.view((S, -1) + hp_aug.shape[1:])),
                self.halo_l.reduce(hl_aug.view((S, -1) + hl_aug.shape[1:])))

    def lms_of(self, lb, like):
        """The solved (S, BL, 2) blocks -> the (NL, 2) landmarks in id order
        (ownership follows observation, not id)."""
        full = self.mesh.gather(lb)
        owner = torch.as_tensor(self.part.lm_owner, dtype=torch.int64, device=full.device)
        local = torch.as_tensor(self.part.lm_local, dtype=torch.int64, device=full.device)
        return full[owner, local].to(like.device)


def _bmv(M, v):
    """Blockwise M @ v: (..., d, d) and (..., d) -> (..., d)."""
    return (M @ v[..., None])[..., 0]


def _damped_inverse(D, lam, free):
    """`pose_graph._damped_inverse` on (S, B, d, d) blocks."""
    return pg._damped_inverse(D.flatten(0, 1), lam, free.flatten()).view(D.shape)


def optimize_se2_partitioned(
    g: PoseGraph2D,
    mesh,
    iters: int = 10,
    cg_iters: int = 100,
    lm_lambda0: float = 1e-4,
    halo_mode: str = "auto",
    precond: str = "jacobi",
):
    """LM over a pose-block partition; returns (graph, chi2_trace, stats).

    Convergence matches `optimize_se2` up to reduction order; state, edges,
    diagonal blocks and CG vectors are sharded.

    precond: "jacobi" (trajectory-identical to the single-device solver) or
    "chain": each shard cyclic-reduction-factors ITS OWN block's
    odometry-chain tridiagonal with no extra communication; boundary chain
    edges stay unpreconditioned.
    """
    if precond not in PRECONDITIONERS_SE2:
        raise ValueError(f"precond must be one of {PRECONDITIONERS_SE2}, got {precond!r}")
    part = partition_se2(g, mesh.size, halo_mode=halo_mode)
    sh = _Shards2D(part, mesh)
    free_p, free_l = sh.free_p[..., None], sh.free_l[..., None]

    def chi2_of(pb, lb):
        return sh.chi2(pg.linearize_se2(sh.graph(pb, lb)))

    pb, lb = sh.poses0, sh.lms0
    trace = [chi2_of(pb, lb)]
    lam = torch.tensor(lm_lambda0, dtype=pb.dtype, device=pb.device)
    cg_total = 0
    for _ in range(iters):
        gk = sh.graph(pb, lb)
        lin = pg.linearize_se2(gk)
        chi2 = sh.chi2(lin)
        gp, gl = sh.reduce(*pg._grad_se2(gk, lin))
        Dp, Dl = sh.reduce(*pg._diag_blocks_se2(gk, lin))
        edge_hvp = pg._hvp_edges_se2(gk, lin)

        def hvp(v, edge_hvp=edge_hvp, Dp=Dp, Dl=Dl, lam=lam):
            vp, vl = v[0] * free_p, v[1] * free_l
            hp, hl = sh.reduce(*edge_hvp((sh.halo.gather_aug(vp).flatten(0, 1),
                                          sh.halo_l.gather_aug(vl).flatten(0, 1))))
            hp = hp + lam * _bmv(Dp, vp)
            hl = hl + lam * _bmv(Dl, vl)
            return hp * free_p + (1.0 - free_p) * v[0], hl * free_l + (1.0 - free_l) * v[1]

        Dl_inv = _damped_inverse(Dl, lam, sh.free_l)
        if precond == "chain":
            # per-shard block-local chain tridiagonal: factored with cyclic
            # reduction, applied shard-locally, no communication
            L_pre, U_pre = sh.chain_blocks(lin)
            Dp_d = pg._damped(Dp.flatten(0, 1), lam, sh.free_p.flatten()).view(Dp.shape)
            fac = cr_factor(L_pre, Dp_d, U_pre)

            def pre(r, fac=fac, Dl_inv=Dl_inv):
                return cr_solve(fac, r[0]), _bmv(Dl_inv, r[1])
        else:
            Dp_inv = _damped_inverse(Dp, lam, sh.free_p)

            def pre(r, Dp_inv=Dp_inv, Dl_inv=Dl_inv):
                return _bmv(Dp_inv, r[0]), _bmv(Dl_inv, r[1])

        (dp, dl), cg_k, _ = pcg(hvp, (-gp * free_p, -gl * free_l), pre, max_iters=cg_iters, rtol=1e-8,
                                tree_dot=sh.dot)
        new_pb = pb + dp * free_p
        new_pb = torch.cat([new_pb[..., :2], lie.wrap_angle(new_pb[..., 2:])], -1)
        new_lb = lb + dl * free_l
        new_chi2 = chi2_of(new_pb, new_lb)
        accept = new_chi2 < chi2
        pb = torch.where(accept, new_pb, pb)
        lb = torch.where(accept, new_lb, lb)
        lam = torch.where(accept, torch.clamp_min(lam * 0.5, 1e-10), torch.clamp_max(lam * 4.0, 1e8))
        trace.append(torch.where(accept, new_chi2, chi2))
        cg_total += cg_k
    g_out = g.with_poses(sh.blocks_of(pb, g.poses), sh.lms_of(lb, g.landmarks))
    stats = {"partition": partition_stats(part), "comm": comm_volume(part, iters, cg_total), "cg_total": cg_total}
    return g_out, torch.stack(trace), stats


# -- SE3: pose-only graphs, 7-dim state, 6-DOF twist updates ---------------------


class PartitionedSE3(NamedTuple):
    poses_blk: np.ndarray  # (D, B, 7)
    free_p_blk: np.ndarray  # (D, B) f32
    ghost_ids: np.ndarray  # (D, G) int32
    pp_ij: np.ndarray  # (D, E, 2) int32 local slots
    pp_meas: np.ndarray  # (D, E, 7)
    pp_info: np.ndarray  # (D, E, 6, 6)
    pp_mask: np.ndarray  # (D, E) bool
    pp_chain: np.ndarray  # (D, E) bool: block-internal consecutive edges
    pp_bnd: np.ndarray  # (D, E) bool: right-boundary consecutive edge
    n_poses: int
    halo: HaloSpec


def partition_se3(g, n_dev: int) -> PartitionedSE3:
    """Block-partition a PoseGraph3D over n_dev shards (host-side)."""
    g = _host(g)
    poses = np.asarray(g.poses)
    pose_mask = np.asarray(g.pose_mask)
    fixed = np.asarray(g.fixed)
    NP = int(pose_mask.sum())
    B = -(-NP // n_dev)

    pp_ij = np.asarray(g.pp_ij)
    pp_mask = np.asarray(g.pp_mask)
    own = [[] for _ in range(n_dev)]
    for k in np.where(pp_mask)[0]:
        own[min(pp_ij[k, 0], pp_ij[k, 1]) // B].append(k)
    E = max(8, max((len(b) for b in own), default=0))

    ghosts = []
    for s in range(n_dev):
        lo, hi = s * B, (s + 1) * B
        gset = {
            int(p)
            for k in own[s]
            for p in pp_ij[k]
            if not (lo <= p < hi)
        }
        ghosts.append(sorted(gset))
    G = max(8, max((len(gl) for gl in ghosts), default=0))

    poses_blk = np.zeros((n_dev, B, 7), np.float32)
    poses_blk[..., 6] = 1.0  # identity quaternion w for padding slots
    free_p_blk = np.zeros((n_dev, B), np.float32)
    ghost_ids = np.zeros((n_dev, G), np.int32)
    pp_ij_l = np.zeros((n_dev, E, 2), np.int32)
    pp_meas_l = np.zeros((n_dev, E, 7), np.float32)
    pp_meas_l[..., 6] = 1.0
    pp_info_l = np.zeros((n_dev, E, 6, 6), np.float32)
    pp_mask_l = np.zeros((n_dev, E), bool)
    pp_chain_l = np.zeros((n_dev, E), bool)
    pp_bnd_l = np.zeros((n_dev, E), bool)
    pp_meas = np.asarray(g.pp_meas)
    pp_info = np.asarray(g.pp_info)

    for s in range(n_dev):
        lo = s * B
        blk = poses[lo : lo + B]
        poses_blk[s, : len(blk)] = blk
        free_p_blk[s, : len(blk)] = (pose_mask & ~fixed)[lo : lo + B]
        gmap = {p: B + r for r, p in enumerate(ghosts[s])}
        ghost_ids[s, : len(ghosts[s])] = ghosts[s]

        def loc(p):
            return p - lo if lo <= p < lo + B else gmap[int(p)]

        for r, k in enumerate(own[s]):
            pp_ij_l[s, r] = (loc(pp_ij[k, 0]), loc(pp_ij[k, 1]))
            pp_meas_l[s, r] = pp_meas[k]
            pp_info_l[s, r] = pp_info[k]
            pp_mask_l[s, r] = True
            pp_chain_l[s, r] = (
                pp_ij[k, 1] == pp_ij[k, 0] + 1
                and lo <= pp_ij[k, 0] < lo + B - 1
            )
            pp_bnd_l[s, r] = (
                pp_ij[k, 1] == pp_ij[k, 0] + 1 and pp_ij[k, 0] == lo + B - 1
            )
    return PartitionedSE3(
        poses_blk, free_p_blk, ghost_ids,
        pp_ij_l, pp_meas_l, pp_info_l, pp_mask_l, pp_chain_l, pp_bnd_l, NP,
        build_halo_spec(ghosts, B, n_dev, G),
    )


def optimize_se3_partitioned(
    g: PoseGraph3D,
    mesh,
    iters: int = 10,
    cg_iters: int = 100,
    lm_lambda0: float = 1e-4,
    precond: str = "jacobi",
):
    """SE3 twin of `optimize_se2_partitioned`: pose blocks + ghost halos;
    returns (graph, chi2_trace).

    precond: "jacobi" (block-diagonal) or "spike": each shard
    cyclic-reduction-factors its local 6x6 block tridiagonal and the
    boundary couplings form the replicated SPIKE interface system
    (`spike.py`), the distributed form of the single-device chain
    preconditioner.
    """
    if precond not in PRECONDITIONERS_SE3:
        raise ValueError(f"precond must be one of {PRECONDITIONERS_SE3}, got {precond!r}")
    part = partition_se3(g, mesh.size)
    sh = _Shards(part, mesh, free_next=True)
    loc, S, B, P = mesh.local, sh.S, sh.B, sh.B + sh.G
    dev = sh.poses0.device
    graph0 = PoseGraph3D(sh.poses0.new_zeros((S * P, 7)), torch.ones(S * P, dtype=torch.bool, device=dev),
                         offset_pairs(sh.pp_ij, P, P, mesh=mesh), loc(part.pp_meas).flatten(0, 1),
                         loc(part.pp_info).flatten(0, 1), loc(part.pp_mask).flatten(0, 1),
                         torch.zeros(S * P, dtype=torch.bool, device=dev))
    I, J = sh.pp_ij[..., 0], sh.pp_ij[..., 1]
    I_flat, J_flat = graph0.pp_ij[:, 0], graph0.pp_ij[:, 1]
    free_p = sh.free_p[..., None]

    def linearize(pb):
        return pg.linearize_se3(graph0.with_poses(sh.halo.gather_aug(pb).flatten(0, 1)))

    def reduce(a, b):
        """Per-edge terms at both endpoints -> own (S, B, ...) blocks."""
        return sh.halo.reduce(sh.segment_sum(a, I, P) + sh.segment_sum(b, J, P))

    pb = sh.poses0
    trace = [sh.chi2(linearize(pb))]
    lam = torch.tensor(lm_lambda0, dtype=pb.dtype, device=dev)
    for _ in range(iters):
        lin = linearize(pb)
        chi2 = sh.chi2(lin)
        we = torch.einsum("kij,kj->ki", lin.w_pp, lin.e_pp)
        gp = reduce(torch.einsum("kdi,kd->ki", lin.Ji_pp, we), torch.einsum("kdi,kd->ki", lin.Jj_pp, we))
        Dp = reduce(pg._jtwj(lin.Ji_pp, lin.w_pp, lin.Ji_pp), pg._jtwj(lin.Jj_pp, lin.w_pp, lin.Jj_pp))

        def hvp(v, lin=lin, Dp=Dp, lam=lam):
            vp = v[0] * free_p
            va = sh.halo.gather_aug(vp).flatten(0, 1)
            Jv = torch.einsum("kdi,ki->kd", lin.Ji_pp, va[I_flat]) + torch.einsum("kdi,ki->kd", lin.Jj_pp, va[J_flat])
            WJv = torch.einsum("kde,ke->kd", lin.w_pp, Jv)
            hp = reduce(torch.einsum("kdi,kd->ki", lin.Ji_pp, WJv), torch.einsum("kdi,kd->ki", lin.Jj_pp, WJv))
            hp = hp + lam * _bmv(Dp, vp)
            return (hp * free_p + (1.0 - free_p) * v[0],)

        Dp_d = pg._damped(Dp.flatten(0, 1), lam, sh.free_p.flatten()).view(Dp.shape)
        if precond == "spike":
            L_pre, U_pre = sh.chain_blocks(lin)
            sf = spike_factor(L_pre, Dp_d, U_pre, sh.boundary_block(lin), mesh)

            def pre(r, sf=sf):
                return (spike_solve(sf, r[0], mesh),)
        else:
            Dp_inv = pg._inv(Dp_d)

            def pre(r, Dp_inv=Dp_inv):
                return (_bmv(Dp_inv, r[0]),)

        (dp,), _, _ = pcg(hvp, (-gp * free_p,), pre, max_iters=cg_iters, rtol=1e-8, tree_dot=sh.dot)
        new_pb = pg._T_to_pose7(pg._pose7_to_T(pb) @ lie.se3_exp(dp * free_p))
        new_chi2 = sh.chi2(linearize(new_pb))
        accept = new_chi2 < chi2
        pb = torch.where(accept, new_pb, pb)
        lam = torch.where(accept, torch.clamp_min(lam * 0.5, 1e-10), torch.clamp_max(lam * 4.0, 1e8))
        trace.append(torch.where(accept, new_chi2, chi2))
    return g.with_poses(sh.blocks_of(pb, g.poses)), torch.stack(trace)
