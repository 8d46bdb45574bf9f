"""PyTorch port: the SE3 pose graph's inner PCG as one kernel launch an LM
iteration (``ops/se3_pcg``, ``csrc/se3_pcg.cu``), which
``solvers/pose_graph.optimize_se3`` runs inside its head.

On the CPU: the plain version (`solve` on CPU tensors) equals the CG of the
pre-graph `optimize_se3` (``tests/pre_graph_solvers.py``) bit for bit (x,
r.z, step count) at every LM iteration, for both preconditioners, on
simulated worlds of several sizes, padded as the map reflector pads them
(masked poses and edges) and with a fixed gauge; also for a right-hand side
that stops at once and for a cap that binds. `pose_graph.chi2_se3`, which
the solve's start and tail read, is `linearize_se3`'s chi2 bit for bit. The
wrapper raises on a wrong dtype, device or shape; the kernel's inputs are
laid out as the kernel reads them; its choice of shared memory or scratch
follows the shapes.

On the card (skipped here; no JAX in this file: ``python3 -m pytest
tests/test_torch_se3_pcg.py -m cuda --noconftest``): the kernel against the
plain version on the same CUDA tensors at the map's shapes (64 to 1,024
poses, edges up to twice the poses, both preconditioners, both layouts):
the same step count, x within 1e-2 of the plain x's norm (40-60 float32 CG
steps amplify the parting that the order of sums makes: up to 2.7e-3 at
250 poses with the chain preconditioner, on an H100);
two launches bit for bit the same; the scratch layout bit-equal to the
shared one; a graphed `optimize_se3` launches the kernel once an LM
iteration and reads the host once a solve.
"""
import pytest
import torch

from g2o_frontend_tpu_torch.ops import se3_pcg
from g2o_frontend_tpu_torch.ops import segment_sum as ss
from g2o_frontend_tpu_torch.solvers import pose_graph as pg
from g2o_frontend_tpu_torch.solvers import tridiag
from g2o_frontend_tpu_torch.utils import graphs
from tools import se3_pcg_probe


def bits(a, b):
    a, b = torch.as_tensor(a).cpu(), torch.as_tensor(b).cpu()
    return a.shape == b.shape and a.dtype == b.dtype and a.numpy().tobytes() == b.numpy().tobytes()


def world(n_poses, pad, seed=2):
    return se3_pcg_probe.world(n_poses, "cpu", seed, pad)


def _pre():
    """``tests/pre_graph_solvers.py``, imported by the CPU tests alone: the
    card's run of this file (``--noconftest``) needs no ``tests`` package
    on its path."""
    from tests import pre_graph_solvers

    return pre_graph_solvers


def recorded_cgs(g, precond, iters=3, cg_iters=30):
    """Every CG of the pre-graph `optimize_se3` on `g`: (the `System` its
    operators read, b, max_iters, rtol, (x, k, r.z)), and its operators."""
    pre = _pre()
    calls = []
    real = pre.pcg

    def recording(hvp, b, precond_fn, *, max_iters, rtol, tree_dot=None):
        out = real(hvp, b, precond_fn, max_iters=max_iters, rtol=rtol)
        calls.append((hvp, precond_fn, b[0], max_iters, rtol, out))
        return out

    pre.pcg = recording
    try:
        pre.optimize_se3(g, iters=iters, cg_iters=cg_iters, precond=precond)
    finally:
        pre.pcg = real
    NP = g.poses.shape[0]
    free = (g.pose_mask & ~g.fixed).to(g.poses.dtype)
    I_seg, J_seg = ss.SegmentIndex(g.pp_ij[:, 0], NP), ss.SegmentIndex(g.pp_ij[:, 1], NP)
    out = []
    for hvp, precond_fn, b, max_iters, rtol, result in calls:
        lin, Dp, lam = hvp.__defaults__
        (pre_t,) = precond_fn.__defaults__
        system = se3_pcg.System(lin.Ji_pp, lin.Jj_pp, lin.w_pp, I_seg, J_seg, Dp, lam, free, pre_t)
        out.append((system, b, max_iters, rtol, result, hvp, precond_fn))
    return out


# -- on the CPU ---------------------------------------------------------------------------


@pytest.mark.parametrize("precond", ["jacobi", "chain"])
@pytest.mark.parametrize("n_poses, pad", [(12, False), (50, True), (90, True)])
def test_plain_version_equals_the_pre_graph_cg(precond, n_poses, pad):
    pre = _pre()
    g = world(n_poses, pad)
    assert bool(g.fixed[0]) and (not pad or not bool(g.pose_mask[-1]))
    cgs = recorded_cgs(g, precond)
    assert len(cgs) == 3
    for system, b, max_iters, rtol, (x, k, rz), _, _ in cgs:
        c = se3_pcg.solve(system, b, rtol, max_iters)
        assert bits(c.x[0], x[0]) and bits(c.rz, rz) and int(c.k) == k and c.k.dtype == torch.int64
    system, b, _, rtol, _, hvp, precond_fn = cgs[0]
    for rhs, cap, steps in ((torch.zeros_like(b), 30, 0), (b, 1, 1)):  # stops at once; the cap binds
        x, k, rz = pre.pcg(hvp, (rhs,), precond_fn, max_iters=cap, rtol=rtol)
        c = se3_pcg.solve(system, rhs, rtol, cap)
        assert bits(c.x[0], x[0]) and bits(c.rz, rz) and int(c.k) == k == steps and bool(rz > 0) == (steps > 0)


@pytest.mark.parametrize("huber_delta", [None, 0.05])
def test_chi2_se3_is_the_linearization_chi2(huber_delta):
    """The solve's start and tail read `chi2_se3`: the chi2 of
    `linearize_se3`, bit for bit, on perturbed padded poses."""
    g = world(50, True)
    gen = torch.Generator().manual_seed(3)
    g = g.with_poses(g.poses + 0.02 * torch.randn(g.poses.shape, generator=gen))
    chi2 = pg.chi2_se3(g, huber_delta)
    assert float(chi2) > 1.0 and bits(chi2, pg.linearize_se3(g, huber_delta).chi2)


def test_solve_checks_its_arguments():
    g = world(12, False)
    (system, b, _, rtol, _, _, _), *_ = recorded_cgs(g, "chain", iters=1)
    bad = [(system._replace(Ji=system.Ji.double()), b, "float32"),
           (system, b.double(), "float32"),
           (system._replace(Dp=system.Dp.to("meta")), b, "one device"),
           (system, b[:, :5], "shape"),
           (system._replace(free=system.free[:-1]), b, "shape"),
           (system._replace(I_seg=ss.SegmentIndex(system.I_seg.index[:-1], b.shape[0])), b, "edges"),
           (system._replace(pre=system.Dp[:-1]), b, "shape")]
    for s, rhs, what in bad:
        with pytest.raises(ValueError, match=what):
            se3_pcg.solve(s, rhs, rtol, 10)
    desc, leaves = graphs.flatten(system)
    meta = graphs.unflatten(desc, [x.to("meta") for x in leaves])
    with pytest.raises(ValueError, match="CPU or CUDA"):
        se3_pcg.solve(meta, b.to("meta"), rtol, 10)
    assert se3_pcg.launches == 0  # the CPU runs the plain version


def test_layout_chooses_shared_memory_or_scratch():
    fine = se3_pcg.layout(1024, 1024, 2048)  # the map's fine pass: everything in shared memory
    assert fine.vectors_shared and fine.terms_shared and fine.scratch_floats == 0
    assert fine.smem == 4 * (se3_pcg.RED_FLOATS + 5 * 1024 * 6 + 1024 + 2048 * 12) <= se3_pcg.MAX_SMEM
    wide = se3_pcg.layout(1024, 1024, 4096)  # the terms go to scratch
    assert wide.vectors_shared and not wide.terms_shared and wide.scratch_floats == 4096 * 12
    big = se3_pcg.layout(3000, 4096, 8192)  # both
    assert not big.vectors_shared and not big.terms_shared
    assert big.scratch_floats == (4 * 3000 + 4096) * 6 + 3000 + 8192 * 12 and big.smem == 4 * se3_pcg.RED_FLOATS
    coarse = se3_pcg.layout(128, 128, 256)
    assert coarse.vectors_shared and coarse.terms_shared
    with pytest.raises(ValueError):
        se3_pcg.layout(64, 32, 10)
    with pytest.raises(ValueError):
        se3_pcg.layout(64, 64, 2**26)


def test_packed_inputs_are_where_the_kernel_reads_them():
    g = world(50, True)
    (system, *_), *_ = recorded_cgs(g, "chain", iters=1)
    f = system.pre
    n = f.n
    buf = se3_pcg.pack_factor(f)
    assert buf.shape == (180 * (n - 1) + 36,)
    for lvl, level in enumerate(zip(f.dinv_odd, f.l_odd, f.u_odd, f.a, f.c)):
        h = n >> (lvl + 1)
        at = 180 * (n - (n >> lvl))
        for m, t in enumerate(level):
            assert bits(buf[at + 36 * h * m: at + 36 * h * (m + 1)], t.reshape(-1))
    assert bits(buf[180 * (n - 1):], f.dinv_root.reshape(-1))
    B = se3_pcg.off_diagonal(system)
    assert B.shape == system.Ji.shape and B.is_contiguous()
    assert torch.allclose(B[3], system.Ji[3].T @ system.w[3] @ system.Jj[3], rtol=1e-5, atol=1e-3)
    for seg in (system.I_seg, system.J_seg):
        pos = se3_pcg.ranks(seg)
        assert pos.dtype == torch.int32 and bits(seg.order[pos.long()], torch.arange(pos.shape[0], dtype=torch.int32))
    assert isinstance(f, tridiag.CRFactor)


# -- on the card --------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("precond", ["jacobi", "chain"])
@pytest.mark.parametrize("n_poses, cg_iters", [(60, 60), (250, 40), (1000, 40)])
def test_kernel_matches_the_plain_version_on_the_card(precond, n_poses, cg_iters):
    g = se3_pcg_probe.world(n_poses, _card(), seed=5)
    assert g.pp_ij.shape[0] <= 2 * g.poses.shape[0]
    recorded = se3_pcg_probe.systems(g, precond, iters=3, cg_iters=cg_iters)
    assert len(recorded) == 3
    for s, b, rtol, max_iters in recorded:
        c = se3_pcg_probe.compare(s, b, rtol, max_iters)
        assert c["k"] == c["k_plain"] > 0 and c["rel_x"] <= 1e-2 and c["relaunch_bit_equal"], c


@pytest.mark.cuda
def test_scratch_layout_gives_the_shared_layouts_bits_on_the_card(monkeypatch):
    """The same system with every vector and term in scratch (a smaller
    shared-memory limit in the layout) gives the shared layout's bits."""
    g = se3_pcg_probe.world(250, _card(), seed=7)
    s, b, rtol, m = se3_pcg_probe.systems(g, "chain")[0]
    shared = se3_pcg.solve(s, b, rtol, m)
    monkeypatch.setattr(se3_pcg, "MAX_SMEM", 4 * se3_pcg.RED_FLOATS)
    assert not se3_pcg.layout(b.shape[0], s.pre.n, s.Ji.shape[0]).vectors_shared
    scratch = se3_pcg.solve(s, b, rtol, m)
    assert all(bits(u, v) for u, v in zip(graphs.flatten(shared)[1], graphs.flatten(scratch)[1]))


@pytest.mark.cuda
def test_graphed_solve_reads_the_host_once_on_the_card():
    g = se3_pcg_probe.world(250, _card(), seed=9)
    outs = []
    for _ in range(3):  # the key's first call, the chain's capture, a replay
        graphs.host_reads, se3_pcg.launches = 0, 0
        out = pg.optimize_se3(g, iters=4, cg_iters=40, precond="chain")
        outs.append((out, graphs.host_reads, se3_pcg.launches))
    for (gk, st), reads, launches in outs:
        assert reads == 1 and launches == 4 and st.cg_iters > 0
        assert bits(gk.poses, outs[0][0][0].poses) and bits(st.chi2, outs[0][0][1].chi2)
