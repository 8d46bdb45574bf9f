"""PyTorch port: the gather probes against the Pallas kernels of
scripts/profile_pallas_gather.py.

The Pallas bodies ``k_a``, ``k_b2`` and ``k_c`` and the script's seeded
inputs are taken from the script with ``ast`` (importing it would run all
four probes and point JAX's compile cache at the home directory); the
kernels run through ``pl.pallas_call`` in interpret mode on the CPU. The
port runs its plain versions on the CPU (the CUDA kernel is held against
the same plain versions on the card by chip_smoke.py, phase 10).

Tolerances: none. A gather copies values, so every comparison is bit for
bit, with NaN (the fill of ``jnp.take_along_axis`` for an index out of
range) in the same places; kernel 2's gather probe sums integers, so its
plain version is held exactly against a numpy count of the same loads.
"""
import ast
import contextlib
import io
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from g2o_frontend_tpu_torch.apps import profile_gather as pg
from g2o_frontend_tpu_torch.ops import fused_aligner as fa
from g2o_frontend_tpu_torch.ops import gather_probe as gp
from g2o_frontend_tpu_torch.pwn.aligner import AlignerConfig
from g2o_frontend_tpu_torch.pwn.converter import ConverterConfig, depth_to_cloud
from g2o_frontend_tpu_torch.utils import lie, profiling, synth

torch.set_num_threads(1)

SCRIPT = pathlib.Path(__file__).resolve().parent.parent / "scripts" / "profile_pallas_gather.py"
# the Pallas body of each probe of `tpu_probes`, in order
BODIES = ("k_a", "k_a", "k_b2", "k_c")
PROBE_IDS = ("lanes_8x128", "lanes_8x1024", "sublanes_1024x128", "flat_8192")


@pytest.fixture(scope="module")
def script():
    """The script's three kernel bodies and its inputs (x, i, x2, i2, x3, i3,
    xc, ic), executed from its source with numpy and jnp in scope."""
    tree = ast.parse(SCRIPT.read_text())
    inputs = {"rng", "x", "i", "x2", "i2", "x3", "i3", "xc", "ic"}
    keep = [
        n for n in tree.body
        if isinstance(n, ast.FunctionDef) and n.name in set(BODIES)
        or isinstance(n, ast.Assign) and len(n.targets) == 1 and getattr(n.targets[0], "id", None) in inputs
    ]
    ns = {"np": np, "jnp": jnp}
    exec(compile(ast.Module(body=keep, type_ignores=[]), str(SCRIPT), "exec"), ns)
    assert set(BODIES) | inputs <= set(ns)
    return ns


def _pallas(body, x, i, out_shape):
    return np.asarray(pl.pallas_call(
        body,
        out_shape=jax.ShapeDtypeStruct(out_shape, jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 2,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )(jnp.asarray(x), jnp.asarray(i)))


def _out_shape(g):
    i = g.args[1]
    return (i.shape[0], g.args[2]) if g.fn is gp.flat_gather else tuple(i.shape)


def _assert_bit_equal(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape
    nan = np.isnan(a)
    np.testing.assert_array_equal(nan, np.isnan(b))
    np.testing.assert_array_equal(a.view(np.int32)[~nan], b.view(np.int32)[~nan])


@pytest.mark.parametrize("k", range(4), ids=PROBE_IDS)
def test_probe_matches_pallas_interpret(script, k):
    """The port's probe k on the script's own inputs equals the script's
    Pallas kernel, run in interpret mode."""
    g = pg.tpu_probes("cpu")[k]
    x, i = g.args[:2]
    names = [("x", "i"), ("x2", "i2"), ("x3", "i3"), ("xc", "ic")][k]
    np.testing.assert_array_equal(x.numpy(), np.asarray(script[names[0]]))
    np.testing.assert_array_equal(i.numpy(), np.asarray(script[names[1]]))
    assert x.dtype == torch.float32 and i.dtype == torch.int32
    ref = _pallas(script[BODIES[k]], x.numpy(), i.numpy(), _out_shape(g))
    out = g.fn(*g.args)
    _assert_bit_equal(out.numpy(), ref)
    _assert_bit_equal(g.library().reshape(out.shape).numpy(), ref)


@pytest.mark.parametrize("k", range(4), ids=PROBE_IDS)
def test_out_of_range_matches_take_along_axis(script, k):
    """Indices that wrap from the end and fall out of range: the plain
    version equals ``jnp.take_along_axis`` and the Pallas kernel in
    interpret mode, NaN where the index is out of range."""
    g = pg.out_of_range_probes("cpu")[k]
    x, i = (a.numpy() for a in g.args[:2])
    n = x.size if g.fn is gp.flat_gather else x.shape[1 if BODIES[k] == "k_a" else 0]
    assert ((i < -n) | (i >= n)).any() and ((i < 0) & (i >= -n)).any() and ((i >= 0) & (i < n)).any()
    if g.fn is gp.flat_gather:
        cols = g.args[2]
        want = jnp.take_along_axis(jnp.broadcast_to(x.reshape(1, -1), (i.shape[0], x.size)), i, axis=1)[:, :cols]
    else:
        want = jnp.take_along_axis(x, i, axis=1 if BODIES[k] == "k_a" else 0)
    out = g.fn(*g.args).numpy()
    assert np.isnan(out).any()
    _assert_bit_equal(out, want)
    _assert_bit_equal(out, _pallas(script[BODIES[k]], x, i, _out_shape(g)))


@pytest.fixture(scope="module")
def scene():
    """A 96x128 pair of the synthetic room: port clouds on the CPU, the
    packed current planes, the reference table and the true params."""
    proj = synth.default_projector(H=96, W=128)
    ccfg = ConverterConfig(min_image_radius=3, max_image_radius=8, min_points=12)
    T = lie.se3_exp(torch.tensor([0.03, -0.01, 0.02, 0.01, -0.02, 0.015])).double().numpy()
    ref, cur = (depth_to_cloud(synth.render_planes_depth(P, proj, device="cpu"), proj, ccfg) for P in (np.eye(4), T))
    params = fa.params_from_invT(torch.as_tensor(np.linalg.inv(T), dtype=torch.float32))
    return dict(proj=proj, cur_packed=fa.pack_cur(cur), table=fa.pack_ref(ref), params=params)


def test_projective_gather_equals_aligner_fetch(scene):
    """flat_gather over pack_ref's table with the projective indices gives,
    for every current pixel, the reference row that
    `fused_aligner.gather_correspondences` fetches there."""
    proj, c = scene["proj"], scene["cur_packed"]
    g = pg.aligner_gathers(c, scene["table"], scene["params"], proj)[1]
    assert g.name == "128x96 projective" and g.args[1].shape == (proj.rows * proj.cols, fa.C_REF)
    rows = g.fn(*g.args)
    mask, rp, rn = fa.gather_correspondences(c[0:3], c[3:6], c[6], c[7] > 0, scene["table"], scene["params"], proj,
                                             AlignerConfig())
    planes = rows.T.reshape(fa.C_REF, proj.rows, proj.cols)
    _assert_bit_equal(planes[0:3].numpy(), rp.numpy())
    _assert_bit_equal(planes[3:6].numpy(), rn.numpy())
    inside, _ = fa.project_to_reference(c[0:3], c[7] > 0, scene["params"], proj)
    assert int(mask.sum()) > 0.5 * proj.rows * proj.cols and not bool((mask & ~inside).any())


def test_aligner_patterns(scene):
    """Identity gives the table back; random is a permutation of its rows;
    over K stacked tables, candidate k's rows come from table k."""
    table, proj = scene["table"], scene["proj"]
    hw = proj.rows * proj.cols
    tables = torch.stack([table, table.flip(0), 2 * table])
    params = torch.stack([scene["params"]] * 3)
    identity, projective, random, stacked = pg.aligner_gathers(
        scene["cur_packed"], table, scene["params"], proj, [(scene["cur_packed"], tables, params, proj)]
    )
    _assert_bit_equal(identity.fn(*identity.args).numpy(), table.numpy())
    perm = torch.as_tensor(np.random.default_rng(0).permutation(hw))
    _assert_bit_equal(random.fn(*random.args).numpy(), table[perm].numpy())
    out = stacked.fn(*stacked.args).reshape(3, hw, fa.C_REF)
    one = projective.fn(*projective.args)
    pix = pg.projective_pixels(scene["cur_packed"], scene["params"], proj)
    for k in range(3):
        _assert_bit_equal(out[k].numpy(), tables[k][pix].numpy())
    _assert_bit_equal(out[0].numpy(), one.numpy())
    # each index read and each value written once, and the 32 B table row
    # of each distinct pixel a candidate fetches
    rows = 3 * int(torch.unique(pix).numel())
    assert stacked.n_bytes == 2 * 4 * 3 * hw * fa.C_REF + 32 * rows and stacked.replaces.endswith(":103")
    assert identity.n_bytes == random.n_bytes == 2 * 4 * hw * fa.C_REF + 32 * hw


def test_app_runs_on_cpu():
    """The probe app with --device cpu: part (a) at the TPU shapes, with the
    script's first values, and part (b) marked as not measured."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        r = pg.run(["--device", "cpu"])
    text = out.getvalue()
    assert r["device"] == "cpu" and r["widths"] == [] and "not measured" in text
    assert [p["replaces"].rsplit(":", 1)[1] for p in r["probes"]] == ["47", "61", "80", "103"]
    assert text.count(" OK ") == 8
    for p, g in zip(r["probes"], pg.tpu_probes("cpu")):
        np.testing.assert_array_equal(np.float32(p["out"]), g.plain(*g.args).reshape(-1)[:4].numpy())


def test_wrappers_check_their_inputs():
    """On a device that is neither CPU nor CUDA the wrappers raise; the
    checks that guard the kernel refuse a wrong dtype, rank or layout."""
    x, i = torch.zeros(4, 8), torch.zeros(4, 8, dtype=torch.int32)
    for fn, args in ((gp.take_along_lanes, (x, i)), (gp.take_along_sublanes, (x, i)), (gp.flat_gather, (x, i, 8))):
        with pytest.raises(ValueError):
            fn(*(a.to("meta") if isinstance(a, torch.Tensor) else a for a in args))
    gp._check(x, i, 2)
    for bad_x, bad_i, ndim in ((x.double(), i, 2), (x, i.long(), 2), (x[None], i, 2), (x, i[0], 2), (x.T, i.T, 2)):
        with pytest.raises(ValueError):
            gp._check(bad_x, bad_i, ndim)


@pytest.mark.parametrize("kind", ["lanes", "sublanes", "flat"])
def test_bytes_count_distinct_sectors(kind):
    """n_bytes: 4 B per index read and per value written, and 32 B per
    distinct sector of x that an in-range index reads; an index out of range
    reads nothing, one that wraps reads where it lands."""
    x = torch.arange(64 * 16, dtype=torch.float32).reshape(64, 16)
    i = torch.tensor([[0, 1, -64, 64], [7, 8, 9, -200]], dtype=torch.int32)
    if kind == "lanes":  # x[r, i[r, c]] of a (64, 16) table, all in range: rows 0 and 1 touch 2 sectors each
        g = pg._lanes("t", x, i.clamp(-16, 15), 47)
        sectors = 4
    elif kind == "sublanes":  # x[i, c] for 4 columns of a (64, 4) table
        xs = x[:, :4].contiguous()
        g = pg._sublanes("t", xs, i, 80)
        j = i.long()
        ok = (j >= -64) & (j < 64)
        flat = (torch.where(j < 0, j + 64, j) * 4 + torch.arange(4))[ok]
        sectors = torch.unique(flat // 8).numel()
    else:  # x.ravel()[i[:, :3]]: 0, 1 and 7 in sector 0, 8 and 9 in sector 1, -64 wraps to sector 120
        g = pg._flat("t", x, i, 3)
        sectors = 3
    assert g.n_bytes == 2 * 4 * (i.shape[0] * (3 if kind == "flat" else 4)) + 32 * sectors


def test_kernel2_gather_reference_counts_its_loads(scene):
    """projective_gather_sum's plain version (the CPU path of the wrapper):
    for each candidate the pixels that project into the image, and the sum
    modulo 2**32 of the bit patterns of every current channel and of each
    fetched reference row, counted here in numpy from
    `fused_aligner.project_to_reference`."""
    c, proj, table = scene["cur_packed"], scene["proj"], scene["table"]
    tables = torch.stack([table, table.flip(0), 2 * table])
    xi = np.array([[0.0, 0, 0, 0, 0, 0], [0.02, 0, -0.01, 0, 0.01, 0], [0, 0.5, 0, 0.3, 0, 0]])
    params = torch.stack([scene["params"]] + [
        fa.params_from_invT(lie.se3_exp(torch.tensor(x, dtype=torch.float32)) @ torch.linalg.inv(
            lie.se3_exp(torch.tensor([0.03, -0.01, 0.02, 0.01, -0.02, 0.015]))))
        for x in xi[1:]])
    out = gp.projective_gather_sum(c, tables, params, proj)
    assert out.dtype == torch.int32 and out.shape == (3, 2)
    cur_bits = int(c.numpy().view(np.uint32).astype(np.uint64).sum())
    for k in range(3):
        inside, idx = fa.project_to_reference(c[0:3], c[7] > 0, params[k], proj)
        rows = tables[k].numpy()[idx.reshape(-1).numpy()[inside.reshape(-1).numpy()]]
        bits = (cur_bits + int(rows.view(np.uint32).astype(np.uint64).sum())) % 2**32
        assert int(out[k, 0]) == int(inside.sum()) > 0
        assert np.int32(out[k, 1]).view(np.uint32) == bits
    assert int(out[2, 0]) < int(out[0, 0])  # a pose that looks away fetches fewer rows


def test_kernel2_gather_bytes(scene):
    """system_bytes: every current channel, 32 B per distinct reference row
    fetched, the params and the outputs; fetched_rows sums the candidates."""
    c, proj = scene["cur_packed"], scene["proj"]
    params = torch.stack([scene["params"], scene["params"]])
    inside, idx = fa.project_to_reference(c[0:3], c[7] > 0, scene["params"], proj)
    rows = int(torch.unique(idx[inside]).numel())
    assert 0 < rows < int(inside.sum()) and pg.fetched_rows(c, params, proj) == 2 * rows
    hw = proj.rows * proj.cols
    assert pg.system_bytes(c, scene["params"], proj, fa.N_SUMS) == 4 * (fa.C_CUR * hw + fa.N_PARAMS + fa.N_SUMS) + 32 * rows
    assert pg.system_bytes(c, params, proj, 2) == 4 * (fa.C_CUR * hw + 2 * (fa.N_PARAMS + 2)) + 64 * rows


def test_measure_rotates_input_copies():
    """measure times each call on the next copy of the inputs, as many copies
    as stream twice the L2 (at most one per call), and bounds by bytes."""
    g = pg.tpu_probes("cpu")[0]
    seen = []
    g.fn = lambda x, i: seen.append(x.data_ptr()) or gp.take_along_lanes(x, i)
    m = pg.measure(g, n=8)
    assert m["copies"] == 8 and len(set(seen)) == 8
    assert m["bound_ms"] == profiling.bound(g.n_bytes)[0] and m["bytes"] == g.n_bytes
    assert all(np.isfinite(m[k]) and m[k] > 0 for k in ("ms", "plain_ms", "library_ms"))
    table = (torch.zeros(640 * 480, 8), torch.zeros(640 * 480, 8, dtype=torch.int32), 8)  # 19.7 MB
    assert pg.input_copies(table, 20) == (6, 2 * 4 * 8 * 640 * 480)
    assert pg.input_copies((torch.zeros(2**27),), 20)[0] == 1


def test_bound_takes_the_slower_peak():
    t, by = profiling.bound(3.35e9)
    assert by == "bytes" and t == pytest.approx(1.0)
    t, by = profiling.bound(0, 67e9)
    assert by == "operations" and t == pytest.approx(1.0)


def test_kernel2_gather_checks_its_inputs(scene):
    """Off CPU and CUDA it raises; on the card the aligner's input checks
    guard the kernel."""
    c, proj = scene["cur_packed"], scene["proj"]
    with pytest.raises(ValueError):
        gp.projective_gather_sum(c.to("meta"), scene["table"][None], scene["params"][None], proj)
