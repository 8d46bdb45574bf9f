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
"""
from __future__ import annotations

import torch

from ..graph.store import PoseGraph2D
from ..solvers import pose_graph as pg
from ..solvers.pcg import pcg
from ..utils import lie
from .mesh import offset_pairs, shard_rows, tile


def shard_chi2(e, w, S):
    """(S,) each shard's chi2 from per-edge residuals and (masked) weights."""
    return torch.einsum("ki,kij,kj->k", e, w, e).reshape(S, -1).sum(1)


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

    def psum_rows(x, n):
        return mesh.psum(x.view((S, n) + x.shape[1:]))[0]

    def linearize(poses, lms):
        gk = flat.with_poses(tile(poses, S), tile(lms, S))
        lin = pg.linearize_se2(gk)
        chi2 = shard_chi2(lin.e_pp, lin.w_pp, S)
        if lin.e_pl is not None:
            chi2 = chi2 + shard_chi2(lin.e_pl, lin.w_pl, S)
        return gk, lin, mesh.psum(chi2)[0]

    poses, lms = g.poses.to(dev), g.landmarks.to(dev)
    trace = [linearize(poses, lms)[2]]
    lam = torch.tensor(lm_lambda0, dtype=dtype, device=dev)
    for _ in range(iters):
        gk, lin, chi2 = linearize(poses, lms)
        gp, gl = pg._grad_se2(gk, lin)
        Dp, Dl = pg._diag_blocks_se2(gk, lin)
        gp, gl, Dp, Dl = psum_rows(gp, NP), psum_rows(gl, NL), psum_rows(Dp, NP), psum_rows(Dl, NL)
        edge_hvp = pg._hvp_edges_se2(gk, lin)

        def sharded_edge_hvp(v, edge_hvp=edge_hvp):
            hp, hl = edge_hvp((tile(v[0], S), tile(v[1], S)))
            return psum_rows(hp, NP), psum_rows(hl, NL)

        hvp = pg._compose_hvp(sharded_edge_hvp, free_p, free_l, lam, Dp, Dl)
        pre = pg._block_jacobi_precond(Dp, Dl, free_p, free_l, lam)
        (dp, dl), _, _ = pcg(hvp, (-gp * free_p[:, None], -gl * free_l[:, None]), pre, max_iters=cg_iters, rtol=1e-8)
        new_poses = poses + dp * free_p[:, None]
        new_poses = torch.cat([new_poses[:, :2], lie.wrap_angle(new_poses[:, 2:])], 1)
        new_lms = lms + dl * free_l[:, None]
        new_chi2 = linearize(new_poses, new_lms)[2]
        accept = new_chi2 < chi2
        poses = torch.where(accept, new_poses, poses)
        lms = torch.where(accept, new_lms, lms)
        lam = torch.where(accept, torch.clamp_min(lam * 0.5, 1e-10), torch.clamp_max(lam * 4.0, 1e8))
        trace.append(torch.where(accept, new_chi2, chi2))
    return g.with_poses(poses.to(g.poses.device), lms.to(g.poses.device)), torch.stack(trace)
