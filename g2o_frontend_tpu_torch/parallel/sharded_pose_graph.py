"""Edge-sharded distributed SE2 pose-graph optimization (counterpart of
``g2o_frontend_tpu/parallel/sharded_pose_graph.py``).

The edge set is block-partitioned across the mesh; pose and landmark
state is replicated. Each shard linearizes its own edges and scatters its
partial gradient, diagonal blocks and Hessian-vector products; a `psum`
adds them up. The PCG iteration then runs replicated, identically on every
shard: two all-reduces of (NP*3 + NL*2) floats a CG matvec.

On a `StackedMesh` the S shards' edges are linearized as one batch: the
replicated state is tiled S times and each shard's endpoints are offset
into its own copy, so that the scatter-adds of the single-device solver
(`solvers/pose_graph.py`) give each shard's partial sums, which `psum`
then adds. Convergence equals the single-device solver's up to reduction
order.

The LM loop is the JAX version's ``fori_loop`` run by
`utils.graphs.solve_loop` as `solvers/pose_graph.optimize_se2` runs it: a
head (linearize, the psum'd gradient and diagonal, CG's start), CG in
blocks of `pcg.BLOCK` masked steps (`pcg.cg_loop`, the stopping test on
the device) and a tail (step, accept or reject, lambda), each a CUDA
graph on the card. The tensors the operators read reach them as the
solve's inputs and its head's outputs, so that a graph reads them from its
static buffers; the mesh is a static argument (`mesh.py`). A
`ProcessMesh` runs the same pieces: over NCCL captured, over gloo (CPU
tensors) eagerly, with the masked blocks.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..graph.store import PoseGraph2D
from ..solvers import pose_graph as pg
from ..solvers.pcg import cg_carry, cg_loop
from ..utils import graphs, lie
from .mesh import offset_pairs, shard_rows, tile


def shard_chi2(e, w, S):
    """(S,) each shard's chi2 from per-edge residuals and (masked) weights."""
    return torch.einsum("ki,kij,kj->k", e, w, e).reshape(S, -1).sum(1)


class _Consts(NamedTuple):
    flat: PoseGraph2D  # the S shards' edges over S tiled copies of the state
    free_p: torch.Tensor
    free_l: torch.Tensor
    seg: pg.EdgeSegments


class _Params(NamedTuple):
    """The solve's static arguments (part of its graphs' key)."""

    mesh: object
    S: int
    NP: int
    NL: int


class _Mid(NamedTuple):
    lin: pg.Linearization
    chi2: torch.Tensor  # the psum'd chi2
    Dp: torch.Tensor
    Dl: torch.Tensor
    lam: torch.Tensor
    pre: tuple  # the block-Jacobi inverses
    tol2: torch.Tensor


def _psum_rows(prm, x, n):
    return prm.mesh.psum(x.view((prm.S, n) + x.shape[1:]))[0]


def _linearize(c, prm, poses, lms):
    gk = c.flat.with_poses(tile(poses, prm.S), tile(lms, prm.S))
    lin = pg.linearize_se2(gk)
    chi2 = shard_chi2(lin.e_pp, lin.w_pp, prm.S)
    if lin.e_pl is not None:
        chi2 = chi2 + shard_chi2(lin.e_pl, lin.w_pl, prm.S)
    return gk, lin, prm.mesh.psum(chi2)[0]


def _head(inputs, st: pg.LMState):
    c, prm = inputs
    gk, lin, chi2 = _linearize(c, prm, st.poses, st.lms)
    gp, gl = pg._grad_se2(gk, lin, c.seg)
    Dp, Dl = pg._diag_blocks_se2(gk, lin, c.seg)
    gp, gl = _psum_rows(prm, gp, prm.NP), _psum_rows(prm, gl, prm.NL)
    Dp, Dl = _psum_rows(prm, Dp, prm.NP), _psum_rows(prm, Dl, prm.NL)
    pre = (pg._damped_inverse(Dp, st.lam, c.free_p), pg._damped_inverse(Dl, st.lam, c.free_l))
    mid = _Mid(lin, chi2, Dp, Dl, st.lam, pre, None)
    carry, tol2 = cg_carry((-gp * c.free_p[:, None], -gl * c.free_l[:, None]), _operators((inputs, mid))[1], 1e-8)
    return mid._replace(tol2=tol2), carry


def _operators(cs):
    (c, prm), mid = cs
    edge_hvp = pg._hvp_edges_se2(c.flat, mid.lin, c.seg)

    def sharded_edge_hvp(v):
        hp, hl = edge_hvp((tile(v[0], prm.S), tile(v[1], prm.S)))
        return _psum_rows(prm, hp, prm.NP), _psum_rows(prm, hl, prm.NL)

    Dp_inv, Dl_inv = mid.pre

    def pre(r):
        return torch.einsum("kij,kj->ki", Dp_inv, r[0]), torch.einsum("kij,kj->ki", Dl_inv, r[1])

    return pg._compose_hvp(sharded_edge_hvp, c.free_p, c.free_l, mid.lam, mid.Dp, mid.Dl), pre


def _tail(inputs, st: pg.LMState, mid: _Mid, carry) -> pg.LMState:
    c, prm = inputs
    dp, dl = carry.x
    new_poses = st.poses + dp * c.free_p[:, None]
    new_poses = torch.cat([new_poses[:, :2], lie.wrap_angle(new_poses[:, 2:])], 1)
    new_lms = st.lms + dl * c.free_l[:, None]
    new_chi2 = _linearize(c, prm, new_poses, new_lms)[2]
    accept = new_chi2 < mid.chi2
    poses = torch.where(accept, new_poses, st.poses)
    lms = torch.where(accept, new_lms, st.lms)
    lam = torch.where(accept, torch.clamp_min(st.lam * 0.5, 1e-10), torch.clamp_max(st.lam * 4.0, 1e8))
    trace = pg.trace_put(st.trace, st.k, torch.where(accept, new_chi2, mid.chi2))
    return pg.LMState(poses, lms, lam, trace, st.k + 1, st.cg_total + carry.k)


def optimize_se2_sharded(g: PoseGraph2D, mesh, iters: int = 10, cg_iters: int = 100, lm_lambda0: float = 1e-4):
    """LM-optimize with edges sharded over `mesh`; returns (graph, chi2 trace)."""
    dev, dtype = mesh.device, g.poses.dtype
    NP, NL = g.poses.shape[0], g.landmarks.shape[0]
    pp = [shard_rows(getattr(g, f), mesh) for f in ("pp_ij", "pp_meas", "pp_info", "pp_mask")]
    pl = [shard_rows(getattr(g, f), mesh) for f in ("pl_ij", "pl_meas", "pl_info", "pl_mask")]
    S = pp[0].shape[0]
    flat = PoseGraph2D(
        poses=tile(g.poses.to(dev), S), pose_mask=tile(g.pose_mask.to(dev), S),
        landmarks=tile(g.landmarks.to(dev), S), landmark_mask=tile(g.landmark_mask.to(dev), S),
        pp_ij=offset_pairs(pp[0], NP, NP, mesh=mesh), pp_meas=pp[1].flatten(0, 1), pp_info=pp[2].flatten(0, 1),
        pp_mask=pp[3].flatten(0, 1), pl_ij=offset_pairs(pl[0], NP, NL, mesh=mesh), pl_meas=pl[1].flatten(0, 1),
        pl_info=pl[2].flatten(0, 1), pl_mask=pl[3].flatten(0, 1), fixed=tile(g.fixed.to(dev), S))
    free_p = (g.pose_mask & ~g.fixed).to(device=dev, dtype=dtype)
    free_l = g.landmark_mask.to(device=dev, dtype=dtype)
    # the edge ends sorted once, for every sum of the solve
    inputs = (_Consts(flat, free_p, free_l, pg.edge_segments(flat)), _Params(mesh, S, NP, NL))
    poses, lms = g.poses.to(dev), g.landmarks.to(dev)
    state = pg._start(poses, _linearize(*inputs, poses, lms)[2], lm_lambda0, iters, lms)
    solve = graphs.Solve(_head, _tail, pg._cg_report, cg_loop(_operators, lambda cs: cs[1].tol2, cg_iters))
    st, _ = graphs.solve_loop("optimize_se2_sharded", solve, inputs, state, iters)
    return g.with_poses(st.poses.to(g.poses.device), st.lms.to(g.poses.device)), st.trace

