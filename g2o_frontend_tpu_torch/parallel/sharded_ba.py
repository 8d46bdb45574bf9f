"""Distributed Schur-complement BA with the observations sharded over the
mesh (counterpart of ``g2o_frontend_tpu/parallel/sharded_ba.py``).

Each shard linearizes its block of observations and scatters partial
(NP, 6) / (NL, 3) reduction vectors and partial block diagonals; a `psum`
assembles the global quantities, and the Schur-PCG iterates replicated,
with psums in every operator product. The landmark elimination (H_pp^-1)
is computed redundantly on every shard from the psum'd point blocks.

The LM loop runs through `utils.graphs.solve_loop` as
`sharded_pose_graph.py`'s does: a head, CG in masked blocks, a tail.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import segment_sum as ss
from ..solvers.ba import BAProblem, _linearize
from ..solvers.pcg import cg_carry, cg_loop
from ..solvers.pose_graph import LMState, _cg_report, _inv, _jtwj, _pose7_to_T, _start, _T_to_pose7, trace_put
from ..utils import graphs, lie
from .mesh import offset_pairs, shard_rows, tile
from .sharded_pose_graph import shard_chi2


class _Consts(NamedTuple):
    flat: BAProblem  # the S shards' observations over S tiled copies of the state
    ci_seg: ss.SegmentIndex
    pi_seg: ss.SegmentIndex
    free_c: torch.Tensor
    free_p: torch.Tensor


class _Params(NamedTuple):
    mesh: object
    S: int
    NP: int
    NL: int


class _Mid(NamedTuple):
    chi2: torch.Tensor
    Jc: torch.Tensor
    Jp: torch.Tensor
    w: torch.Tensor
    g_p: torch.Tensor
    H_pp_inv: torch.Tensor
    lam_D: torch.Tensor
    D_inv: torch.Tensor
    tol2: torch.Tensor


def _psum_seg(prm, x, seg, n):
    """Each shard's segment sum into n rows, psum'd."""
    return prm.mesh.psum(ss.segment_sum(x, seg).view((prm.S, n) + x.shape[1:]))[0]


def _local_lin(c, prm, poses, points, jacobians=True):
    e, Jc, Jp, w, _ = _linearize(c.flat._replace(poses=tile(poses, prm.S), points=tile(points, prm.S)), jacobians)
    return e, Jc, Jp, w, prm.mesh.psum(shard_chi2(e, w, prm.S))[0]


def _Hcp(c, prm, mid, vp):  # (NL, 3) -> (NP, 6)
    pi = c.flat.obs_ij[:, 1]
    WJv = torch.einsum("kde,ke->kd", mid.w, torch.einsum("kdi,ki->kd", mid.Jp, tile(vp, prm.S)[pi]))
    return _psum_seg(prm, torch.einsum("kdi,kd->ki", mid.Jc, WJv), c.ci_seg, prm.NP)


def _Hpc(c, prm, mid, vc):  # (NP, 6) -> (NL, 3)
    ci = c.flat.obs_ij[:, 0]
    WJv = torch.einsum("kde,ke->kd", mid.w, torch.einsum("kdi,ki->kd", mid.Jc, tile(vc, prm.S)[ci]))
    return _psum_seg(prm, torch.einsum("kdi,kd->ki", mid.Jp, WJv), c.pi_seg, prm.NL)


def _head(inputs, st: LMState):
    c, prm = inputs
    dtype, dev = st.poses.dtype, st.poses.device
    eye3, eye6 = torch.eye(3, dtype=dtype, device=dev), torch.eye(6, dtype=dtype, device=dev)
    lam = st.lam
    e, Jc, Jp, w, chi2 = _local_lin(c, prm, st.poses, st.lms)
    we = torch.einsum("kij,kj->ki", w, e)
    g_c = _psum_seg(prm, torch.einsum("kdi,kd->ki", Jc, we), c.ci_seg, prm.NP)
    g_p = _psum_seg(prm, torch.einsum("kdi,kd->ki", Jp, we), c.pi_seg, prm.NL)
    D_c = _psum_seg(prm, _jtwj(Jc, w, Jc), c.ci_seg, prm.NP)
    H_pp = _psum_seg(prm, _jtwj(Jp, w, Jp), c.pi_seg, prm.NL)
    H_pp_inv = _inv(torch.where(c.free_p[:, None, None] > 0, H_pp + (lam * H_pp * eye3 + 1e-6 * eye3), eye3))
    lam_D = lam * D_c * eye6
    D_inv = _inv(torch.where(c.free_c[:, None, None] > 0, D_c + lam_D + 1e-6 * eye6, eye6))
    mid = _Mid(chi2, Jc, Jp, w, g_p, H_pp_inv, lam_D, D_inv, None)
    b_s = (-g_c + _Hcp(c, prm, mid, torch.einsum("kij,kj->ki", H_pp_inv, g_p))) * c.free_c[:, None]
    carry, tol2 = cg_carry((b_s,), _operators((inputs, mid))[1], 1e-8)
    return mid._replace(tol2=tol2), carry


def _operators(cs):
    (c, prm), mid = cs
    free_c, ci = c.free_c, c.flat.obs_ij[:, 0]

    def schur_hvp(v):
        vc = v[0] * free_c[:, None]
        WJv = torch.einsum("kde,ke->kd", mid.w, torch.einsum("kdi,ki->kd", mid.Jc, tile(vc, prm.S)[ci]))
        hcc = (_psum_seg(prm, torch.einsum("kdi,kd->ki", mid.Jc, WJv), c.ci_seg, prm.NP)
               + torch.einsum("kij,kj->ki", mid.lam_D, vc))
        out = hcc - _Hcp(c, prm, mid, torch.einsum("kij,kj->ki", mid.H_pp_inv, _Hpc(c, prm, mid, vc)))
        return (out * free_c[:, None] + (1.0 - free_c)[:, None] * v[0],)

    def precond(r):
        return (torch.einsum("kij,kj->ki", mid.D_inv, r[0]),)

    return schur_hvp, precond


def _tail(inputs, st: LMState, mid: _Mid, carry) -> LMState:
    c, prm = inputs
    dc = carry.x[0] * c.free_c[:, None]
    dp = torch.einsum("kij,kj->ki", mid.H_pp_inv, -mid.g_p - _Hpc(c, prm, mid, dc)) * c.free_p[:, None]
    new_poses = _T_to_pose7(_pose7_to_T(st.poses) @ lie.se3_exp(dc))
    new_points = st.lms + dp
    new_chi2 = _local_lin(c, prm, new_poses, new_points, False)[4]
    accept = new_chi2 < mid.chi2
    poses = torch.where(accept, new_poses, st.poses)
    points = torch.where(accept, new_points, st.lms)
    lam = torch.where(accept, torch.clamp_min(st.lam * 0.5, 1e-10), torch.clamp_max(st.lam * 4.0, 1e8))
    trace = trace_put(st.trace, st.k, torch.where(accept, new_chi2, mid.chi2))
    return LMState(poses, points, lam, trace, st.k + 1, st.cg_total + carry.k)


def optimize_ba_sharded(ba: BAProblem, mesh, iters: int = 10, cg_iters: int = 50, lm_lambda0: float = 1e-4):
    """Observation-sharded LM-BA; returns (problem, chi2 trace)."""
    dev, dtype = mesh.device, ba.poses.dtype
    NP, NL = ba.poses.shape[0], ba.points.shape[0]
    ij, z, info, mask = (shard_rows(getattr(ba, f), mesh) for f in ("obs_ij", "obs_z", "obs_info", "obs_mask"))
    S = ij.shape[0]
    flat = BAProblem(tile(ba.poses.to(dev), S), tile(ba.pose_mask.to(dev), S), tile(ba.points.to(dev), S),
                     tile(ba.point_mask.to(dev), S), offset_pairs(ij, NP, NL, mesh=mesh), z.flatten(0, 1),
                     info.flatten(0, 1), mask.flatten(0, 1), tile(ba.fixed.to(dev), S))
    ci, pi = flat.obs_ij[:, 0], flat.obs_ij[:, 1]
    free_c = (ba.pose_mask & ~ba.fixed).to(device=dev, dtype=dtype)
    free_p = ba.point_mask.to(device=dev, dtype=dtype)
    # every sum's index sorted once a solve
    inputs = (_Consts(flat, ss.SegmentIndex(ci, S * NP), ss.SegmentIndex(pi, S * NL), free_c, free_p),
              _Params(mesh, S, NP, NL))
    poses, points = ba.poses.to(dev), ba.points.to(dev)
    state = _start(poses, _local_lin(*inputs, poses, points, False)[4], lm_lambda0, iters, points)
    solve = graphs.Solve(_head, _tail, _cg_report, cg_loop(_operators, lambda cs: cs[1].tol2, cg_iters))
    st, _ = graphs.solve_loop("optimize_ba_sharded", solve, inputs, state, iters)
    return ba._replace(poses=st.poses.to(ba.poses.device), points=st.lms.to(ba.poses.device)), st.trace
