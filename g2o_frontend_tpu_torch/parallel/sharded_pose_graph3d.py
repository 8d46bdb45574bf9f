"""Edge-sharded distributed SE3 pose-graph optimization (counterpart of
``g2o_frontend_tpu/parallel/sharded_pose_graph3d.py``): the 3D twin of
`sharded_pose_graph.py`, with the same psum-per-matvec communication."""
from __future__ import annotations

import torch

from ..graph.store import PoseGraph3D
from ..solvers import pose_graph as pg
from ..solvers.pcg import pcg
from ..utils import lie
from .mesh import offset_pairs, shard_rows, tile
from .sharded_pose_graph import shard_chi2


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

    def psum_rows(x):
        return mesh.psum(x.view((S, NP) + x.shape[1:]))[0]

    def scatter(a, b):
        """Each shard's sum of per-edge terms at both endpoints, psum'd."""
        return psum_rows(pg._segment_sum(a, I, S * NP) + pg._segment_sum(b, J, S * NP))

    def linearize(poses):
        lin = pg.linearize_se3(flat.with_poses(tile(poses, S)))
        return lin, mesh.psum(shard_chi2(lin.e_pp, lin.w_pp, S))[0]

    poses = g.poses.to(dev)
    trace = [linearize(poses)[1]]
    lam = torch.tensor(lm_lambda0, dtype=dtype, device=dev)
    for _ in range(iters):
        lin, chi2 = linearize(poses)
        we = torch.einsum("kij,kj->ki", lin.w_pp, lin.e_pp)
        gp = scatter(torch.einsum("kdi,kd->ki", lin.Ji_pp, we), torch.einsum("kdi,kd->ki", lin.Jj_pp, we))
        Dp = scatter(pg._jtwj(lin.Ji_pp, lin.w_pp, lin.Ji_pp), pg._jtwj(lin.Jj_pp, lin.w_pp, lin.Jj_pp))

        def hvp(v, lin=lin, Dp=Dp, lam=lam):
            vp = tile(v[0] * free_p[:, None], S)
            Jv = torch.einsum("kdi,ki->kd", lin.Ji_pp, vp[I]) + torch.einsum("kdi,ki->kd", lin.Jj_pp, vp[J])
            WJv = torch.einsum("kde,ke->kd", lin.w_pp, Jv)
            hp = scatter(torch.einsum("kdi,kd->ki", lin.Ji_pp, WJv), torch.einsum("kdi,kd->ki", lin.Jj_pp, WJv))
            hp = hp + lam * torch.einsum("kij,kj->ki", Dp, v[0] * free_p[:, None])
            return (hp * free_p[:, None] + (1.0 - free_p)[:, None] * v[0],)

        Dp_inv = pg._damped_inverse(Dp, lam, free_p)

        def pre(r, Dp_inv=Dp_inv):
            return (torch.einsum("kij,kj->ki", Dp_inv, r[0]),)

        (dp,), _, _ = pcg(hvp, (-gp * free_p[:, None],), pre, max_iters=cg_iters, rtol=1e-8)
        new_poses = pg._T_to_pose7(pg._pose7_to_T(poses) @ lie.se3_exp(dp * free_p[:, None]))
        new_chi2 = linearize(new_poses)[1]
        accept = new_chi2 < chi2
        poses = torch.where(accept, new_poses, poses)
        lam = torch.where(accept, torch.clamp_min(lam * 0.5, 1e-10), torch.clamp_max(lam * 4.0, 1e8))
        trace.append(torch.where(accept, new_chi2, chi2))
    return g.with_poses(poses.to(g.poses.device)), torch.stack(trace)
