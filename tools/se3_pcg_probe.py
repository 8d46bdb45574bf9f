"""The SE3 pose graph's PCG kernel (``ops/se3_pcg``, ``csrc/se3_pcg.cu``) at
the map solve's shapes, for the tests of ``tests/test_torch_se3_pcg.py``
and ``chip_smoke.py``'s phase 9:

- `world`: a simulated SE3 world (``slam/simulator.simulate_se3``) padded
  to power-of-two capacities as ``graph/reflector.MapReflector`` pads its
  map (`padded`);
- `systems`: the `se3_pcg.System` and right-hand side of each LM iteration
  of an `optimize_se3` call, recorded by wrapping `se3_pcg.solve`;
- `compare`: the kernel against its plain version on one system on the
  card, the plain version on the card against itself on the CPU (the
  scale of the parting that the order of float32 sums alone makes), and
  both against the plain version in float64 on the same float32 system;
- `timing`: one LM iteration's CG on the card by the kernel, by its plain
  version (both the slope of CUDA graph replays) and by the CG-block
  graphs that ran it before the kernel (``utils/graphs._Blocks`` over
  ``solvers/pcg.cg_loop``: a graph replay and a host read every
  `pcg.BLOCK` steps; whole calls by CUDA events, in turns with the
  kernel's), beside the kernel's bound.

On the card, ``python3 tools/se3_pcg_probe.py`` prints one JSON line for
each shape and preconditioner of the SLAM cell's map solve: the coarse
pass (128 poses, 60 CG steps) and the fine one (1,024 poses, 2,048 edges,
40 steps).
"""
from __future__ import annotations

import json
import os
import statistics
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from g2o_frontend_tpu_torch.graph.store import PoseGraph3D, _cap  # noqa: E402
from g2o_frontend_tpu_torch.ops import se3_pcg  # noqa: E402
from g2o_frontend_tpu_torch.slam.simulator import Simulator3DConfig, simulate_se3  # noqa: E402
from g2o_frontend_tpu_torch.solvers import pcg, tridiag  # noqa: E402
from g2o_frontend_tpu_torch.solvers import pose_graph as pg  # noqa: E402
from g2o_frontend_tpu_torch.utils import graphs, profiling  # noqa: E402

# (label, simulated poses, CG steps): the SLAM cell's coarse and fine passes
SHAPES = (("coarse", 100, 60), ("fine", 1000, 40))


def padded(g: PoseGraph3D, NP: int, EP: int) -> PoseGraph3D:
    """`g` padded to NP poses and EP edges as `MapReflector._pack` pads:
    identity poses and edges from pose 0 to pose 0 with zero information,
    masked off."""
    n, e = g.poses.shape[0], g.pp_ij.shape[0]
    ident = g.poses.new_tensor([0, 0, 0, 0, 0, 0, 1.0])

    def pad(t, rows, fill=0.0):
        return torch.cat([t, t.new_full((rows - t.shape[0],) + t.shape[1:], fill)])

    return PoseGraph3D(poses=torch.cat([g.poses, ident.expand(NP - n, 7)]), pose_mask=pad(g.pose_mask, NP, False),
                       pp_ij=pad(g.pp_ij, EP, 0), pp_meas=torch.cat([g.pp_meas, ident.expand(EP - e, 7)]),
                       pp_info=pad(g.pp_info, EP), pp_mask=pad(g.pp_mask, EP, False), fixed=pad(g.fixed, NP, False))


def world(n_poses, device, seed=2, pad=True) -> PoseGraph3D:
    """A simulated SE3 world of `n_poses` (pose 0 fixed, a closure every
    10 poses or more), padded to the reflector's capacities unless not
    `pad`."""
    g, _ = simulate_se3(Simulator3DConfig(n_poses=n_poses, world_size=6.0, closure_min_gap=10, seed=seed),
                        device=device)
    return padded(g, _cap(n_poses), _cap(g.pp_ij.shape[0])) if pad else g


def systems(g, precond, iters=1, cg_iters=40):
    """[(System, b, rtol, max_iters)] of each LM iteration of
    `optimize_se3(g, iters, cg_iters, precond)`, run in "eager" mode."""
    out = []
    real = se3_pcg.solve

    def recording(s, b, rtol, max_iters):
        out.append((s, b, rtol, max_iters))
        return real(s, b, rtol, max_iters)

    se3_pcg.solve = recording
    try:
        with graphs.mode("eager"):
            pg.optimize_se3(g, iters=iters, cg_iters=cg_iters, precond=precond)
    finally:
        se3_pcg.solve = real
    return out


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30))


def _same_bits(a, b):
    return all(torch.equal(x.view(torch.int32) if x.dtype == torch.float32 else x,
                           y.view(torch.int32) if y.dtype == torch.float32 else y)
               for x, y in zip(graphs.flatten(a)[1], graphs.flatten(b)[1]))


def compare(s, b, rtol, max_iters) -> dict:
    """The kernel against the plain version on one system on the card:
    step counts, x and r.z relative to the plain version's, whether a
    second launch gives the first one's bits, the plain version's x on the
    card relative to its x on the CPU, and the kernel's and the plain
    version's x relative to the plain version's in float64 (the same
    float32 operators, computed in float64)."""
    kern, plain = se3_pcg.solve(s, b, rtol, max_iters), se3_pcg.solve_reference(s, b, rtol, max_iters)
    again = se3_pcg.solve(s, b, rtol, max_iters)
    desc, leaves = graphs.flatten((s, b))
    cpu = se3_pcg.solve_reference(*graphs.unflatten(desc, [x.cpu() for x in leaves]), rtol, max_iters)
    f64 = se3_pcg.solve_reference(*graphs.unflatten(desc, [x.cpu().double() if x.is_floating_point() else x.cpu()
                                                           for x in leaves]), rtol, max_iters)
    torch.cuda.synchronize()
    return dict(k=int(kern.k), k_plain=int(plain.k), rel_x=_rel(kern.x[0], plain.x[0]),
                rel_rz=_rel(kern.rz, plain.rz), relaunch_bit_equal=_same_bits(kern, again),
                plain_cpu_rel_x=_rel(plain.x[0].cpu(), cpu.x[0]), kernel_f64_rel_x=_rel(kern.x[0].cpu(), f64.x[0]),
                plain_f64_rel_x=_rel(plain.x[0].cpu(), f64.x[0]))


def step_bytes(s) -> int:
    """Bytes of the inputs one CG step reads: the edges' off-diagonal
    blocks, ends and ranks, the poses' Dp, free mask and offsets, and the
    preconditioner."""
    NP, EP = s.Dp.shape[0], s.Ji.shape[0]
    pre = (180 * (s.pre.n - 1) + 36 if isinstance(s.pre, tridiag.CRFactor) else 36 * NP) * 4
    return EP * (36 * 4 + 8 + 8) + NP * (36 * 4 + 4 + 8) + pre


def block_path(s, b, rtol, max_iters):
    """The CG as it ran before the kernel: `pcg.cg_loop` over the plain
    operators in CG-block graphs (`graphs._Blocks`, kept across calls as a
    solve's chain kept them), from a start computed once. Returns a
    function of no arguments that runs it to its end."""
    ops = (lambda v: (se3_pcg.hvp(s, v[0]),), lambda r: (se3_pcg.precondition(s, r[0]),))
    carry, tol2 = pcg.cg_carry((b,), ops[1], rtol)
    loop = pcg.cg_loop(lambda cs: ops, lambda cs: cs, max_iters)
    blocks = graphs._Blocks("se3 CG blocks", loop, b.device)
    return lambda: blocks.run(tol2, carry)


def timing(s, b, rtol, max_iters, runs=20) -> dict:
    """One LM iteration's CG on the card (see the module docstring), ms."""
    launches, reads = se3_pcg.launches, graphs.host_reads
    kernel = lambda: se3_pcg.solve(s, b, rtol, max_iters)  # noqa: E731
    old = block_path(s, b, rtol, max_iters)
    steps = int(kernel().k)
    o1, n1, n2, o2 = (statistics.median(profiling.event_ms(f, runs)) for f in (old, kernel, kernel, old))
    graphs.host_reads = 0
    old()
    reads_old = graphs.host_reads
    kernel_ms = profiling.graph_ms(kernel, b)
    plain_ms = profiling.graph_ms(lambda: se3_pcg.solve_reference(s, b, rtol, max_iters), b, n=8)
    se3_pcg.launches, graphs.host_reads = launches, reads
    bound_ms = profiling.bound(steps * step_bytes(s))[0]
    return dict(steps=steps, kernel_ms=kernel_ms, plain_ms=plain_ms, kernel_call_ms=min(n1, n2),
                blocks_call_ms=min(o1, o2), blocks_runs_ms=(o1, o2), kernel_runs_ms=(n1, n2),
                blocks_host_reads=reads_old, bound_ms=bound_ms, step_bytes=step_bytes(s),
                us_per_step=1e3 * kernel_ms / max(steps, 1))


def main():
    dev = torch.device("cuda")
    lib, secs, log = se3_pcg.build()
    print(json.dumps({"build": str(lib), "seconds": secs}), flush=True)
    for label, n_poses, cg in SHAPES:
        g = world(n_poses, dev)
        for precond in ("chain", "jacobi"):
            s, b, rtol, m = systems(g, precond, cg_iters=cg)[0]
            lay = se3_pcg.layout(b.shape[0], s.pre.n if precond == "chain" else b.shape[0], s.Ji.shape[0])
            print(json.dumps(dict(shape=label, precond=precond, poses=b.shape[0], edges=s.Ji.shape[0],
                                  vectors_shared=lay.vectors_shared, terms_shared=lay.terms_shared,
                                  **compare(s, b, rtol, m), **timing(s, b, rtol, m))), flush=True)
    print(profiling.gpu_name_and_power_limit(), flush=True)


if __name__ == "__main__":
    main()
