"""Edge-sharded distributed SE3 pose-graph optimization (counterpart of
``g2o_frontend_tpu/parallel/sharded_pose_graph3d.py``): the 3D twin of
`sharded_pose_graph.py`, with the same psum-per-matvec communication and
the same LM loop through `utils.graphs.solve_loop`."""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..graph.store import PoseGraph3D
from ..ops import segment_sum as ss
from ..solvers import pose_graph as pg
from ..solvers.pcg import cg_carry, cg_loop
from ..utils import graphs, lie
from .mesh import offset_pairs, shard_rows, tile
from .sharded_pose_graph import shard_chi2


class _Consts(NamedTuple):
    flat: PoseGraph3D  # the S shards' edges over S tiled copies of the poses
    I_seg: ss.SegmentIndex
    J_seg: ss.SegmentIndex
    free_p: torch.Tensor


class _Params(NamedTuple):
    mesh: object
    S: int
    NP: int


class _Mid(NamedTuple):
    lin: pg.Linearization
    chi2: torch.Tensor
    Dp: torch.Tensor
    lam: torch.Tensor
    Dp_inv: torch.Tensor
    tol2: torch.Tensor


def _scatter(c, prm, a, b):
    """Each shard's sum of per-edge terms at both endpoints, psum'd."""
    x = ss.segment_sum(a, c.I_seg) + ss.segment_sum(b, c.J_seg)
    return prm.mesh.psum(x.view((prm.S, prm.NP) + x.shape[1:]))[0]


def _linearize(c, prm, poses):
    lin = pg.linearize_se3(c.flat.with_poses(tile(poses, prm.S)))
    return lin, prm.mesh.psum(shard_chi2(lin.e_pp, lin.w_pp, prm.S))[0]


def _head(inputs, st: pg.LMState):
    c, prm = inputs
    lin, chi2 = _linearize(c, prm, st.poses)
    we = torch.einsum("kij,kj->ki", lin.w_pp, lin.e_pp)
    gp = _scatter(c, prm, torch.einsum("kdi,kd->ki", lin.Ji_pp, we), torch.einsum("kdi,kd->ki", lin.Jj_pp, we))
    Dp = _scatter(c, prm, pg._jtwj(lin.Ji_pp, lin.w_pp, lin.Ji_pp), pg._jtwj(lin.Jj_pp, lin.w_pp, lin.Jj_pp))
    mid = _Mid(lin, chi2, Dp, st.lam, pg._damped_inverse(Dp, st.lam, c.free_p), None)
    carry, tol2 = cg_carry((-gp * c.free_p[:, None],), _operators((inputs, mid))[1], 1e-8)
    return mid._replace(tol2=tol2), carry


def _operators(cs):
    (c, prm), mid = cs
    lin, free_p = mid.lin, c.free_p
    I, J = c.flat.pp_ij[:, 0], c.flat.pp_ij[:, 1]

    def hvp(v):
        vp = tile(v[0] * free_p[:, None], prm.S)
        Jv = torch.einsum("kdi,ki->kd", lin.Ji_pp, vp[I]) + torch.einsum("kdi,ki->kd", lin.Jj_pp, vp[J])
        WJv = torch.einsum("kde,ke->kd", lin.w_pp, Jv)
        hp = _scatter(c, prm, torch.einsum("kdi,kd->ki", lin.Ji_pp, WJv), torch.einsum("kdi,kd->ki", lin.Jj_pp, WJv))
        hp = hp + mid.lam * torch.einsum("kij,kj->ki", mid.Dp, v[0] * free_p[:, None])
        return (hp * free_p[:, None] + (1.0 - free_p)[:, None] * v[0],)

    def pre(r):
        return (torch.einsum("kij,kj->ki", mid.Dp_inv, r[0]),)

    return hvp, pre


def _tail(inputs, st: pg.LMState, mid: _Mid, carry) -> pg.LMState:
    c, prm = inputs
    (dp,) = carry.x
    new_poses = pg._T_to_pose7(pg._pose7_to_T(st.poses) @ lie.se3_exp(dp * c.free_p[:, None]))
    new_chi2 = _linearize(c, prm, new_poses)[1]
    accept = new_chi2 < mid.chi2
    poses = torch.where(accept, new_poses, st.poses)
    lam = torch.where(accept, torch.clamp_min(st.lam * 0.5, 1e-10), torch.clamp_max(st.lam * 4.0, 1e8))
    trace = pg.trace_put(st.trace, st.k, torch.where(accept, new_chi2, mid.chi2))
    return pg.LMState(poses, None, lam, trace, st.k + 1, st.cg_total + carry.k)


def optimize_se3_sharded(g: PoseGraph3D, mesh, iters: int = 10, cg_iters: int = 100, lm_lambda0: float = 1e-4):
    """LM-optimize with edges sharded over `mesh`; returns (graph, chi2 trace)."""
    dev, dtype = mesh.device, g.poses.dtype
    NP = g.poses.shape[0]
    ij, meas, info, mask = (shard_rows(getattr(g, f), mesh) for f in ("pp_ij", "pp_meas", "pp_info", "pp_mask"))
    S = ij.shape[0]
    flat = PoseGraph3D(tile(g.poses.to(dev), S), tile(g.pose_mask.to(dev), S), offset_pairs(ij, NP, NP, mesh=mesh),
                       meas.flatten(0, 1), info.flatten(0, 1), mask.flatten(0, 1), tile(g.fixed.to(dev), S))
    I, J = flat.pp_ij[:, 0], flat.pp_ij[:, 1]
    free_p = (g.pose_mask & ~g.fixed).to(device=dev, dtype=dtype)
    inputs = (_Consts(flat, ss.SegmentIndex(I, S * NP), ss.SegmentIndex(J, S * NP), free_p), _Params(mesh, S, NP))
    poses = g.poses.to(dev)
    state = pg._start(poses, _linearize(*inputs, poses)[1], lm_lambda0, iters)
    solve = graphs.Solve(_head, _tail, pg._cg_report, cg_loop(_operators, lambda cs: cs[1].tol2, cg_iters))
    st, _ = graphs.solve_loop("optimize_se3_sharded", solve, inputs, state, iters)
    return g.with_poses(st.poses.to(g.poses.device)), st.trace
