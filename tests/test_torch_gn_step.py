"""PyTorch port: the aligner's Gauss-Newton step (``ops/fused_aligner``
`fused_step`, `step_reference`, `gn_update`; ``csrc/fused_aligner.cu``
``gauss_newton_step_kernel``, launched alone by ``tools/gn_step_probe``).

On the CPU: the step's argument checks; `fused_step` on CPU tensors gives
the bits of the tail that `pwn/aligner._align` ran before the step kernel
(the plain system, damping, solve, chart update, re-orthonormalisation),
and `_align` the bits of that loop for every association, with priors and
with zero inner iterations; `align_batch` the bits of its own loop before
it took `gn_update`; a CPU align counts no launch and no step.

On the card (skipped here; no JAX in this file): the step kernel's sums
bit-equal to reduce_blocks_kernel's fixed f64 order; its invT and params
within 2e-6 (relative, of the norm) of the plain tail's on recorded sums,
and dx within 1e-5 of a float64 solve of the same float32 H and b; two
launches give the same bits; on kernel 1's block rows at 640x480,
`fused_system`'s sums and `fused_step`'s bits; the `align` graph bit-equal to its eager body
with 11 kernel-1 launches and 10 steps; and `align` at 640x480 on the
bench pair within 1e-5 m and 1e-6 rad of the plain tail's pose, inliers
within 0.01%.
"""
import numpy as np
import pytest
import torch

from g2o_frontend_tpu_torch.ops import fused_aligner as fa
from g2o_frontend_tpu_torch.pwn import aligner as al
from g2o_frontend_tpu_torch.pwn import converter as cv
from g2o_frontend_tpu_torch.slam.pwn_matcher import stack_clouds
from g2o_frontend_tpu_torch.utils import lie, synth
from tools import gn_step_probe

H, W = 48, 64
CCFG = cv.ConverterConfig(min_image_radius=2, max_image_radius=6, min_points=8)


@pytest.fixture(scope="module")
def pair():
    d_ref, d_cur, proj, T_gt = synth.bench_pair("cpu", H, W)
    ref, cur = cv.depth_to_cloud(d_ref, proj, CCFG), cv.depth_to_cloud(d_cur, proj, CCFG)
    return dict(proj=proj, T_gt=T_gt, ref=ref, cur=cur, cur_packed=fa.pack_cur(cur), ref_table=fa.pack_ref(ref))


def _invT(pair, pose):
    perturb = lie.se3_exp(torch.tensor([0.02, -0.01, 0.015, 0.01, -0.02, 0.005]))
    inv = torch.as_tensor(np.linalg.inv(pair["T_gt"]), dtype=torch.float32)
    return {"identity": torch.eye(4), "ground_truth": inv, "perturbed": perturb @ inv}[pose]


def _plain_tail(pair, invT, cfg, reorthonormalize):
    """The step as `_align` ran it before the step kernel."""
    sums = fa.fused_system(pair["cur_packed"], pair["ref_table"], fa.params_from_invT(invT), pair["proj"], cfg)
    H_, b, _, _ = fa.unpack_sums(sums)
    dx = torch.linalg.solve_ex(H_ + cfg.damping * torch.eye(6), -b[:, None], check_errors=False).result[:, 0]
    invT = lie.se3_v2t(dx) @ invT
    if reorthonormalize:
        invT = lie.se3_v2t(lie.se3_t2v(invT))
    return invT


def _pre_change_align(ref, cur, proj, T0, cfg, priors):
    """`_align`'s loop before the step kernel: every step on the plain tail."""
    eye6 = torch.eye(6)
    if cfg.association == "zbuffer":
        cur_packed = fa.pack_cur(cur)

        def system(invT):
            mask, rp, rn = al._correspondences(ref, cur, invT, proj, cfg)
            return fa.unpack_sums(al._lin.linearize_system(mask, *al._remap(rp, rn, invT), cur_packed, cfg))
    else:
        cur_packed, ref_table = fa.pack_cur(cur), fa.pack_ref(ref)

        def system(invT):
            return fa.unpack_sums(fa.fused_system(cur_packed, ref_table, fa.params_from_invT(invT), proj, cfg))

    invT = lie.se3_inverse(T0)
    for _ in range(cfg.outer_iterations):
        for _ in range(cfg.inner_iterations):
            H_, b, _, _ = system(invT)
            H_ = H_ + cfg.damping * eye6
            if priors is not None:
                Hp, bp = al._prior_system(priors, invT)
                H_, b = H_ + Hp, b + bp
            dx = torch.linalg.solve_ex(H_, -b[:, None], check_errors=False).result[:, 0]
            invT = lie.se3_v2t(dx) @ invT
        invT = lie.se3_v2t(lie.se3_t2v(invT))
    H_, _, chi2, inliers = system(invT)
    return al._finalize_stats(lie.se3_inverse(invT), H_, chi2, inliers, cfg)


def _bad_inputs(pair):
    cur, table = pair["cur_packed"], pair["ref_table"]
    params, invT = fa.params_from_invT(torch.eye(4)), torch.eye(4)
    flat = torch.zeros(table.numel() + 1)
    return {
        "shape": (cur, table, params, invT[:3]),
        "dtype": (cur, table, params, invT.double()),
        "device": (cur, table, params, invT.to("meta")),
        "contiguity": (cur, table, params, invT.T),
        "alignment": (cur, flat[1:].view(table.shape), params, invT),
    }


@pytest.mark.parametrize("case", ["shape", "dtype", "device", "contiguity", "alignment"])
def test_step_checks_reject_bad_inputs(pair, case):
    cur, table, params, invT = _bad_inputs(pair)[case]
    with pytest.raises(ValueError):
        fa._check(cur, table, params, H, W, invT=invT)
    fa._check(pair["cur_packed"], pair["ref_table"], params, H, W, invT=torch.eye(4))  # the good ones pass


def test_step_kernel_wrapper_rejects_cpu_tensors(pair):
    with pytest.raises(ValueError, match="CUDA"):
        gn_step_probe.step_kernel(torch.zeros(4, fa.N_SUMS), torch.eye(4), 1001.0, True)
    with pytest.raises(ValueError, match="CUDA"):
        gn_step_probe.block_rows(pair["cur_packed"], pair["ref_table"], fa.params_from_invT(torch.eye(4)),
                                 pair["proj"], al.AlignerConfig())


def test_state_layout():
    state = torch.arange(float(fa.N_STATE))
    invT, params, dx, sums = fa._split_state(state)
    assert fa.N_STATE == 75 and invT.shape == (4, 4) and params.shape == (24,) and dx.shape == (6,)
    assert float(invT[0, 0]) == 0 and float(params[0]) == 16 and float(dx[0]) == 40 and float(sums[0]) == 46


@pytest.mark.parametrize("pose", ["identity", "ground_truth", "perturbed"])
@pytest.mark.parametrize("reorthonormalize", [False, True])
def test_cpu_step_is_the_plain_tail(pair, pose, reorthonormalize):
    cfg = al.AlignerConfig()
    invT = _invT(pair, pose)
    params = fa.params_from_invT(invT)
    new, new_params = fa.fused_step(pair["cur_packed"], pair["ref_table"], params, invT, pair["proj"], cfg,
                                    reorthonormalize)
    want = _plain_tail(pair, invT, cfg, reorthonormalize)
    assert torch.equal(new, want)
    assert torch.equal(new_params, fa.params_from_invT(want))


@pytest.mark.parametrize("case", ["auto", "gather", "guess", "inner_2", "inner_0", "zbuffer", "prior"])
def test_cpu_align_is_the_pre_change_loop(pair, case):
    cfg = al.AlignerConfig(outer_iterations=3, association="gather" if case == "gather" else "auto")
    guess, prior = None, None
    if case == "guess":
        guess = torch.as_tensor(pair["T_gt"], dtype=torch.float32)
    elif case == "inner_2":
        cfg = al.AlignerConfig(outer_iterations=2, inner_iterations=2)
    elif case == "inner_0":
        cfg = al.AlignerConfig(outer_iterations=2, inner_iterations=0)
        guess = torch.as_tensor(pair["T_gt"], dtype=torch.float32)
    elif case == "zbuffer":
        cfg = al.AlignerConfig(outer_iterations=2, association="zbuffer")
    elif case == "prior":
        prior = al.absolute_prior(torch.eye(4), torch.as_tensor(np.linalg.inv(pair["T_gt"]), dtype=torch.float32),
                                  10.0 * torch.eye(6))
    got = al.align(pair["ref"], pair["cur"], pair["proj"], guess, cfg, prior)
    T0 = torch.eye(4) if guess is None else guess
    want = _pre_change_align(pair["ref"], pair["cur"], pair["proj"], T0, cfg, prior)
    for name, a, b in zip(al.AlignResult._fields, got, want):
        assert torch.equal(a, b), name
    if case in ("auto", "guess"):
        assert np.linalg.norm(got.T.numpy()[:3, 3] - pair["T_gt"][:3, 3]) < 5e-3


def _pre_change_align_batch(refs, cur, proj, T0, cfg):
    """`_align_batch`'s loop before it took `gn_update`."""
    cur_packed, tables, eye6 = fa.pack_cur(cur), fa.pack_ref(refs), torch.eye(6)

    def systems(invTs):
        return fa.unpack_sums(fa.fused_system_batch(cur_packed, tables, fa.params_from_invT(invTs), proj, cfg))

    invTs = lie.se3_inverse(T0)
    for _ in range(cfg.outer_iterations):
        for _ in range(cfg.inner_iterations):
            H_, b, _, _ = systems(invTs)
            dx = torch.linalg.solve_ex(H_ + cfg.damping * eye6, -b[..., None], check_errors=False).result[..., 0]
            invTs = lie.se3_v2t(dx) @ invTs
        invTs = lie.se3_v2t(lie.se3_t2v(invTs))
    H_, _, chi2, inliers = systems(invTs)
    return al._finalize_stats(lie.se3_inverse(invTs), H_, chi2, inliers, cfg)


@pytest.mark.parametrize("inner", [1, 2, 0])
def test_cpu_align_batch_is_the_pre_change_loop(pair, inner):
    cfg = al.AlignerConfig(outer_iterations=2, inner_iterations=inner)
    guesses = torch.stack([torch.eye(4), torch.as_tensor(pair["T_gt"], dtype=torch.float32)])
    refs = stack_clouds([pair["ref"], pair["ref"]])
    got = al.align_batch(refs, pair["cur"], pair["proj"], guesses, cfg)
    want = _pre_change_align_batch(refs, pair["cur"], pair["proj"], guesses, cfg)
    for name, a, b in zip(al.AlignResult._fields, got, want):
        assert torch.equal(a, b), name


def test_cpu_align_counts_no_launch(pair):
    before = (fa.launches, fa.step_launches, fa.batch_launches)
    al.align(pair["ref"], pair["cur"], pair["proj"], config=al.AlignerConfig(outer_iterations=2))
    assert (fa.launches, fa.step_launches, fa.batch_launches) == before


# -- on the card ------------------------------------------------------------------


def _rel(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float(torch.linalg.norm(a - b) / max(float(torch.linalg.norm(b)), 1e-30))


def _reduce_blocks_order(rows):
    """reduce_blocks_kernel's sums of (n, 29) float32 rows, in its order:
    256 f64 partials (partial t over rows t, t + 256, ...), then the tree
    buf[i] += buf[i + stride], stride 128 .. 1."""
    rows = rows.double().cpu()
    part = torch.zeros(256, rows.shape[1], dtype=torch.float64)
    for base in range(0, rows.shape[0], 256):
        chunk = rows[base:base + 256]
        part[:len(chunk)] += chunk
    stride = 128
    while stride:
        part[:stride] += part[stride:2 * stride]
        stride //= 2
    return part[0].float()


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    d_ref, d_cur, proj, T_gt = synth.bench_pair(dev)
    ref, cur = cv.depth_to_cloud(d_ref, proj), cv.depth_to_cloud(d_cur, proj)
    return dict(proj=proj, T_gt=T_gt, ref=ref, cur=cur, cur_packed=fa.pack_cur(cur), ref_table=fa.pack_ref(ref),
                dev=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 255, 1200, 1537])
def test_step_kernel_sums_keep_the_reduction_order(card, n):
    g = torch.Generator().manual_seed(n)
    rows = (torch.randn(n, fa.N_SUMS, generator=g) * torch.logspace(-3, 6, fa.N_SUMS)).to(card["dev"])
    invT, params, dx, sums = gn_step_probe.step_kernel(rows, torch.eye(4, device=card["dev"]), 1001.0, True)
    assert torch.equal(sums.cpu(), _reduce_blocks_order(rows))
    again = gn_step_probe.step_kernel(rows, torch.eye(4, device=card["dev"]), 1001.0, True)
    assert all(torch.equal(a, b) for a, b in zip((invT, params, dx, sums), again))


@pytest.mark.cuda
@pytest.mark.parametrize("pose", ["identity", "ground_truth", "perturbed"])
@pytest.mark.parametrize("reorthonormalize", [False, True])
def test_step_kernel_is_the_plain_tail_on_recorded_sums(card, pose, reorthonormalize):
    cfg = al.AlignerConfig()
    invT = _invT(card, pose).to(card["dev"])
    sums = fa.fused_system(card["cur_packed"], card["ref_table"], fa.params_from_invT(invT), card["proj"], cfg)
    got = gn_step_probe.step_kernel(sums[None].contiguous(), invT, cfg.damping, reorthonormalize)
    again = gn_step_probe.step_kernel(sums[None].contiguous(), invT, cfg.damping, reorthonormalize)
    assert all(torch.equal(a, b) for a, b in zip(got, again)), "two launches differ"
    k_invT, k_params, k_dx, k_sums = got
    assert torch.equal(k_sums, sums)
    p_invT, p_params = fa.step_reference(sums, invT, cfg.damping, reorthonormalize)
    assert _rel(k_invT, p_invT) < 2e-6, (k_invT, p_invT)
    assert _rel(k_params, p_params) < 2e-6, (k_params, p_params)
    H_, b, _, _ = fa.unpack_sums(sums.double().cpu())
    dx64 = torch.linalg.solve(H_ + cfg.damping * torch.eye(6, dtype=torch.float64), -b)
    assert float((k_dx.double().cpu() - dx64).abs().max()) < 1e-5, (k_dx, dx64)


@pytest.mark.cuda
def test_step_kernel_on_kernel_1s_block_rows(card):
    cfg = al.AlignerConfig()
    invT = _invT(card, "ground_truth").to(card["dev"])
    params = fa.params_from_invT(invT)
    rows, sums = gn_step_probe.block_rows(card["cur_packed"], card["ref_table"], params, card["proj"], cfg)
    assert rows.shape == (fa._load().fused_aligner_blocks(card["proj"].rows * card["proj"].cols), fa.N_SUMS)
    assert torch.equal(sums, fa.fused_system(card["cur_packed"], card["ref_table"], params, card["proj"], cfg))
    k_invT, k_params, _, k_sums = gn_step_probe.step_kernel(rows, invT, cfg.damping, True)
    assert torch.equal(k_sums, sums)
    p_invT, p_params = fa.step_reference(sums, invT, cfg.damping, True)
    assert _rel(k_invT, p_invT) < 2e-6 and _rel(k_params, p_params) < 2e-6
    new_invT, new_params = fa.fused_step(card["cur_packed"], card["ref_table"], params, invT, card["proj"], cfg, True)
    assert torch.equal(new_invT, k_invT) and torch.equal(new_params, k_params)


@pytest.mark.cuda
def test_align_graph_is_its_eager_body_and_counts_steps(card):
    cfg = al.AlignerConfig()
    args = (card["ref"], card["cur"], card["proj"])
    al.align(*args, config=cfg)  # capture
    before = (fa.launches, fa.step_launches)
    res = al.align(*args, config=cfg)
    torch.cuda.synchronize()
    assert (fa.launches - before[0], fa.step_launches - before[1]) == (11, cfg.outer_iterations * cfg.inner_iterations)
    before = (fa.launches, fa.step_launches)
    eager = al._align(*args, None, cfg, None)
    assert (fa.launches - before[0], fa.step_launches - before[1]) == (11, 10)
    for name, a, b in zip(al.AlignResult._fields, res, eager):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_align_is_the_plain_tail_at_640x480(card, monkeypatch):
    cfg = al.AlignerConfig()
    args = (card["ref"], card["cur"], card["proj"], None, cfg, None)
    fused = al._align(*args)

    def plain_step(cur_packed, ref_table, params, invT, projector, cfg, reorthonormalize):
        sums = fa.fused_system(cur_packed, ref_table, params, projector, cfg)
        return fa.step_reference(sums, invT, cfg.damping, reorthonormalize)

    monkeypatch.setattr(fa, "fused_step", plain_step)
    plain = al._align(*args)
    A, B = fused.T.double().cpu().numpy(), plain.T.double().cpu().numpy()
    M = A[:3, :3].T @ B[:3, :3]
    angle = np.arctan2(np.linalg.norm([M[2, 1] - M[1, 2], M[0, 2] - M[2, 0], M[1, 0] - M[0, 1]]) / 2,
                       (np.trace(M) - 1) / 2)
    assert np.linalg.norm(A[:3, 3] - B[:3, 3]) < 1e-5 and angle < 1e-6, (A, B)
    assert abs(int(fused.inliers) - int(plain.inliers)) <= 1e-4 * int(plain.inliers)
    assert np.linalg.norm(A[:3, 3] - card["T_gt"][:3, 3]) < 5e-3
