"""Distributed Schur-complement BA with the observations sharded over the
mesh (counterpart of ``g2o_frontend_tpu/parallel/sharded_ba.py``).

Each shard linearizes its block of observations and scatters partial
(NP, 6) / (NL, 3) reduction vectors and partial block diagonals; a `psum`
assembles the global quantities, and the Schur-PCG iterates replicated,
with psums in every operator product. The landmark elimination (H_pp^-1)
is computed redundantly on every shard from the psum'd point blocks.
"""
from __future__ import annotations

import torch

from ..solvers.ba import BAProblem, _linearize
from ..solvers.pcg import pcg
from ..solvers.pose_graph import _inv, _jtwj, _pose7_to_T, _segment_sum, _T_to_pose7
from ..utils import lie
from .mesh import offset_pairs, shard_rows, tile
from .sharded_pose_graph import shard_chi2


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
    eye3, eye6 = torch.eye(3, dtype=dtype, device=dev), torch.eye(6, dtype=dtype, device=dev)

    def psum_seg(x, index, n):
        """Each shard's segment sum into n rows, psum'd."""
        return mesh.psum(_segment_sum(x, index, S * n).view((S, n) + x.shape[1:]))[0]

    def local_lin(poses, points, jacobians=True):
        e, Jc, Jp, w, _ = _linearize(flat._replace(poses=tile(poses, S), points=tile(points, S)), jacobians)
        return e, Jc, Jp, w, mesh.psum(shard_chi2(e, w, S))[0]

    poses, points = ba.poses.to(dev), ba.points.to(dev)
    trace = [local_lin(poses, points, False)[4]]
    lam = torch.tensor(lm_lambda0, dtype=dtype, device=dev)
    for _ in range(iters):
        e, Jc, Jp, w, chi2 = local_lin(poses, points)
        we = torch.einsum("kij,kj->ki", w, e)
        g_c = psum_seg(torch.einsum("kdi,kd->ki", Jc, we), ci, NP)
        g_p = psum_seg(torch.einsum("kdi,kd->ki", Jp, we), pi, NL)
        D_c = psum_seg(_jtwj(Jc, w, Jc), ci, NP)
        H_pp = psum_seg(_jtwj(Jp, w, Jp), pi, NL)
        H_pp_inv = _inv(torch.where(free_p[:, None, None] > 0, H_pp + (lam * H_pp * eye3 + 1e-6 * eye3), eye3))

        def Hcp_apply(vp, Jc=Jc, Jp=Jp, w=w):  # (NL, 3) -> (NP, 6)
            WJv = torch.einsum("kde,ke->kd", w, torch.einsum("kdi,ki->kd", Jp, tile(vp, S)[pi]))
            return psum_seg(torch.einsum("kdi,kd->ki", Jc, WJv), ci, NP)

        def Hpc_apply(vc, Jc=Jc, Jp=Jp, w=w):  # (NP, 6) -> (NL, 3)
            WJv = torch.einsum("kde,ke->kd", w, torch.einsum("kdi,ki->kd", Jc, tile(vc, S)[ci]))
            return psum_seg(torch.einsum("kdi,kd->ki", Jp, WJv), pi, NL)

        b_s = (-g_c + Hcp_apply(torch.einsum("kij,kj->ki", H_pp_inv, g_p))) * free_c[:, None]
        lam_D = lam * D_c * eye6

        def schur_hvp(v, Jc=Jc, w=w, lam_D=lam_D, H_pp_inv=H_pp_inv, Hcp_apply=Hcp_apply, Hpc_apply=Hpc_apply):
            vc = v[0] * free_c[:, None]
            WJv = torch.einsum("kde,ke->kd", w, torch.einsum("kdi,ki->kd", Jc, tile(vc, S)[ci]))
            hcc = psum_seg(torch.einsum("kdi,kd->ki", Jc, WJv), ci, NP) + torch.einsum("kij,kj->ki", lam_D, vc)
            out = hcc - Hcp_apply(torch.einsum("kij,kj->ki", H_pp_inv, Hpc_apply(vc)))
            return (out * free_c[:, None] + (1.0 - free_c)[:, None] * v[0],)

        D_inv = _inv(torch.where(free_c[:, None, None] > 0, D_c + lam_D + 1e-6 * eye6, eye6))

        def precond(r, D_inv=D_inv):
            return (torch.einsum("kij,kj->ki", D_inv, r[0]),)

        (dc,), _, _ = pcg(schur_hvp, (b_s,), precond, max_iters=cg_iters, rtol=1e-8)
        dc = dc * free_c[:, None]
        dp = torch.einsum("kij,kj->ki", H_pp_inv, -g_p - Hpc_apply(dc)) * free_p[:, None]
        new_poses = _T_to_pose7(_pose7_to_T(poses) @ lie.se3_exp(dc))
        new_points = points + dp
        new_chi2 = local_lin(new_poses, new_points, False)[4]
        accept = new_chi2 < chi2
        poses = torch.where(accept, new_poses, poses)
        points = torch.where(accept, new_points, points)
        lam = torch.where(accept, torch.clamp_min(lam * 0.5, 1e-10), torch.clamp_max(lam * 4.0, 1e8))
        trace.append(torch.where(accept, new_chi2, chi2))
    return ba._replace(poses=poses.to(ba.poses.device), points=points.to(ba.poses.device)), torch.stack(trace)
