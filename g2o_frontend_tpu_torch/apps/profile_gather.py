"""Gather probes on the card (counterpart of
``scripts/profile_pallas_gather.py``).

The TPU script asked whether Mosaic lowers a dynamic gather inside a Pallas
kernel. On Hopper a gather is an ordinary load; what is worth knowing is
how fast it runs where the aligner gathers. Three parts:

(a) the script's four probes at its own shapes, with its seeded inputs
    (``default_rng(0)``, drawn in its order): each a kernel of
    ``ops/gather_probe.py`` held bit for bit against its plain version
    (NaN in the same places) and against ``torch.gather``; then the same
    four with indices that wrap from the end and fall out of range;
(b) the flat gather at the aligner's widths: the reference table of
    ``fused_aligner.pack_ref`` at 640x480 (H*W rows of 8 f32, 9.8 MB)
    flattened, one index per table scalar, in three patterns: identity
    (coalesced), projective (the pixel that
    ``fused_aligner.gather_correspondences`` fetches for each current pixel
    of the bench pair at ground truth) and random (a seeded permutation of
    the pixels); then the projective pattern over K candidate tables, each
    candidate at its own true pose, which no longer fit in the 50 MB L2;
(c) kernel 2's gather in its own pattern (``projective_gather_sum``: the
    indices computed in the kernel, the loads reduced, no index array and
    no output array) beside kernel 2 on the same K candidate tables.

For each gather on the card: the kernel's device time (the slope of CUDA
graph replays timed by CUDA events), the plain version's,
``torch.gather``'s on the same in-range indices (a yardstick the port
never calls), the bound from the bytes the gather must move (each index
read, each output written, each distinct 32 B sector of the table read)
and the rate achieved. Each timing loop rotates over copies of the inputs
that together stream twice the L2, so that the bound's device-memory rate
applies. Any failure raises and the process exits non-zero (the TPU
script printed FAIL and went on). With ``--device cpu`` part (a) runs the
plain versions and parts (b) and (c), measurements of the card, are not
run.

Usage:
  python -m g2o_frontend_tpu_torch.apps.profile_gather [--device cuda]
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import itertools
import json
import math
import sys
from typing import Callable

import numpy as np
import torch

from ..ops import fused_aligner as fa
from ..ops import gather_probe as gp
from ..pwn.aligner import AlignerConfig
from ..pwn.converter import ConverterConfig, depth_to_cloud
from ..slam.pwn_matcher import stack_clouds
from ..utils import synth
from ..utils.profiling import L2_BYTES, CheckFailure, bound, gpu_name_and_power_limit, graph_ms, in_turns

SCRIPT = "scripts/profile_pallas_gather.py"
SECTOR = 32  # bytes: the unit in which the card reads device memory


@dataclasses.dataclass
class Gather:
    """One gather: the wrapper `fn` and its plain version `plain` on `args`
    ((x, i), or (x, i, cols) for the flat gather), ``torch.gather``'s `dim`
    (None for the flat gather) and the Pallas call it stands for."""

    name: str
    fn: Callable
    plain: Callable
    args: tuple
    dim: int | None
    replaces: str

    def _view(self, args):
        """x flattened, the indices read (flattened) and their axis length."""
        x, i = args[0], args[1]
        if self.dim is None:
            return x.reshape(-1), i[:, :args[2]].reshape(-1), x.numel()
        return x, i, x.shape[self.dim]

    def library_for(self, args):
        """The same function by ``torch.gather`` on `args`, as a call with no
        arguments (its int64 indices made beforehand), or None where an index
        falls out of range."""
        x, i, n = self._view(args)
        if not bool(((i >= 0) & (i < n)).all()):
            return None
        dim, i64 = self.dim or 0, i.long()
        return lambda: torch.gather(x, dim, i64)

    @property
    def library(self):
        return self.library_for(self.args)

    @functools.cached_property
    def n_bytes(self):
        """The bytes the function must move: each index it reads, each value
        it writes, and each distinct 32 B sector of x that an in-range index
        reads (x starts on a sector boundary, as every allocation does)."""
        x, i = self.args[0], self.args[1]
        _, used, n = self._view(self.args)
        j = torch.where(used < 0, used + n, used).long()
        ok = (j >= 0) & (j < n)
        if self.dim == 1:  # x (R, N): out[r, c] = x[r, i[r, c]]
            j = j + torch.arange(i.shape[0], device=j.device)[:, None] * x.shape[1]
        elif self.dim == 0:  # x (N, C): out[r, c] = x[i[r, c], c]
            j = j * x.shape[1] + torch.arange(i.shape[1], device=j.device)
        sectors = torch.unique(j[ok] * x.element_size() // SECTOR).numel()
        return 2 * used.numel() * 4 + sectors * SECTOR


def _lanes(name, x, i, line):
    return Gather(name, gp.take_along_lanes, gp.take_along_lanes_reference, (x, i), 1, f"{SCRIPT}:{line}")


def _sublanes(name, x, i, line):
    return Gather(name, gp.take_along_sublanes, gp.take_along_sublanes_reference, (x, i), 0, f"{SCRIPT}:{line}")


def _flat(name, x, i, cols):
    return Gather(name, gp.flat_gather, gp.flat_gather_reference, (x, i, cols), None, f"{SCRIPT}:103")


def _tensors(device, *arrays):
    return [torch.as_tensor(np.asarray(a, np.float32 if a.dtype.kind == "f" else np.int32), device=device)
            for a in arrays]


# -- (a) the TPU script's probes ---------------------------------------------------


def tpu_probes(device="cuda"):
    """The four probes of the TPU script at its shapes, with its inputs:
    ``default_rng(0)``, drawn in the script's order."""
    rng = np.random.default_rng(0)
    x, i = _tensors(device, rng.normal(size=(8, 128)), rng.integers(0, 128, (8, 128)))
    x2, i2 = _tensors(device, rng.normal(size=(8, 1024)), rng.integers(0, 1024, (8, 1024)))
    x3, i3 = _tensors(device, rng.normal(size=(1024, 128)), rng.integers(0, 1024, (8, 128)))
    xc, ic = _tensors(device, rng.normal(size=(64, 128)), rng.integers(0, 8192, (8, 8192)))
    return [
        _lanes("take_along_axis lanes (8,128)", x, i, 47),
        _lanes("take_along_axis lanes (8,1024)", x2, i2, 61),
        _sublanes("take_along_axis sublanes (1024,128)->(8,128)", x3, i3, 80),
        _flat("flat gather (8192,) via broadcast+taa", xc, ic, 128),
    ]


def out_of_range_probes(device="cuda", seed=1):
    """The four probes at the same shapes, with indices drawn over [-2n, 2n):
    a quarter in range, a quarter that wrap from the end, and half out of
    range (NaN)."""
    rng = np.random.default_rng(seed)

    def draw(shape, n):
        return rng.integers(-2 * n, 2 * n, shape)

    x, i = _tensors(device, rng.normal(size=(8, 128)), draw((8, 128), 128))
    x2, i2 = _tensors(device, rng.normal(size=(8, 1024)), draw((8, 1024), 1024))
    x3, i3 = _tensors(device, rng.normal(size=(1024, 128)), draw((8, 128), 1024))
    xc, ic = _tensors(device, rng.normal(size=(64, 128)), draw((8, 8192), 8192))
    return [
        _lanes("lanes (8,128), wrapped and out of range", x, i, 47),
        _lanes("lanes (8,1024), wrapped and out of range", x2, i2, 61),
        _sublanes("sublanes (1024,128)->(8,128), wrapped and out of range", x3, i3, 80),
        _flat("flat (8192,), wrapped and out of range", xc, ic, 128),
    ]


def bit_equal(a, b):
    """Equal bit for bit, where a NaN matches a NaN in the same place."""
    na, nb = torch.isnan(a), torch.isnan(b)
    if a.shape != b.shape or not torch.equal(na, nb):
        return False
    return torch.equal(torch.where(na, 0, a.view(torch.int32)), torch.where(nb, 0, b.view(torch.int32)))


def check(g):
    """Run the kernel once on g's inputs and hold it against the plain
    version (and torch.gather where the indices are in range): bit-equal,
    NaN in the same places. Prints one line; returns (kernel output, plain
    output); raises CheckFailure."""
    out = g.fn(*g.args)
    ref = g.plain(*g.args)
    if not bit_equal(out, ref):
        raise CheckFailure(f"{g.name}: the kernel differs from its plain version")
    if g.library is not None and not bit_equal(out.reshape(-1), g.library().reshape(-1)):
        raise CheckFailure(f"{g.name}: the kernel differs from torch.gather")
    n_nan = int(torch.isnan(out).sum())
    print(f"{g.name:44s} OK  out={out.reshape(-1)[:4].cpu().numpy()}  kernel == plain bit for bit"
          f" ({out.numel()} values, {n_nan} NaN)", flush=True)
    return out, ref


def rotated_ms(fn, arg_sets, like, n):
    """`graph_ms` of `fn`, call j taking ``arg_sets[j % len(arg_sets)]`` and
    every output kept, so that no call finds its inputs or its output in L2
    when the sets together exceed it."""
    sets, kept = itertools.cycle(arg_sets), []
    return graph_ms(lambda: kept.append(fn(*next(sets))), like, n)


def input_copies(args, n):
    """(copies, bytes of one copy): how many copies of the tensors in `args`
    stream twice the L2, at most `n` (one per call of a timing loop)."""
    size = sum(a.numel() * a.element_size() for a in args if isinstance(a, torch.Tensor))
    return min(n, max(1, math.ceil(2 * L2_BYTES / size))), size


def measure(g, n=50):
    """Device times of g on the card, ms per call by CUDA graph replays: the
    kernel's, its plain version's and torch.gather's, each rotating over
    enough copies of g's inputs to stream twice the L2 (at most n copies);
    the bound from the bytes g must move; the rate achieved."""
    x = g.args[0]
    copies, size = input_copies(g.args, n)
    arg_sets = [g.args] + [tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in g.args)
                           for _ in range(copies - 1)]
    ms = rotated_ms(g.fn, arg_sets, x, n)
    bound_ms, _ = bound(g.n_bytes)
    m = {
        "ms": ms,
        "plain_ms": rotated_ms(g.plain, arg_sets, x, n),
        "library_ms": rotated_ms(lambda f: f(), [(g.library_for(a),) for a in arg_sets], x, n),
        "bound_ms": bound_ms,
        "bytes": g.n_bytes,
        "copies": copies,
    }
    m["gb_per_s"] = g.n_bytes / ms / 1e6
    m["share_of_bound"] = bound_ms / ms
    print(f"{'':44s} device ms (CUDA graph replays over {copies} input copies, {copies * size / 2**20:.1f} MiB): "
          f"kernel {ms:.6f}, plain {m['plain_ms']:.6f}, torch.gather {m['library_ms']:.6f}; bound {bound_ms:.6f} "
          f"({g.n_bytes} B); {m['gb_per_s']:.1f} GB/s, {100 * m['share_of_bound']:.2f}% of the bound", flush=True)
    return m


# -- (b) the flat gather at the aligner's widths ------------------------------------


def bench_tables(k, device="cuda"):
    """The bench pair at 640x480 and k candidate references rendered around
    it (``synth.candidate_poses``): (current planes, reference table
    (H*W, 8), params at ground truth, candidate tables (k, H*W, 8), each
    candidate's params at its true pose, projector)."""
    d_ref, d_cur, proj, T_gt = synth.bench_pair(device)
    ccfg = ConverterConfig()
    ref, cur = depth_to_cloud(d_ref, proj, ccfg), depth_to_cloud(d_cur, proj, ccfg)
    poses = synth.candidate_poses(k)
    refs = stack_clouds([depth_to_cloud(synth.bench_depth(P, device), proj, ccfg) for P in poses])
    T_true = np.stack([np.linalg.inv(P) @ T_gt for P in poses])

    def params(T):
        return fa.params_from_invT(torch.as_tensor(np.linalg.inv(T), dtype=torch.float32, device=device))

    return fa.pack_cur(cur), fa.pack_ref(ref), params(T_gt), fa.pack_ref(refs), params(T_true), proj


def projective_pixels(cur_packed, params, projector):
    """The reference pixel that `fused_aligner.gather_correspondences`
    fetches for each current pixel: (H*W,) int64 for params (24,), (K, H*W)
    for params (K, 24)."""
    valid = cur_packed[7] > 0

    def one(p):
        return fa.project_to_reference(cur_packed[0:3], valid, p, projector)[1].reshape(-1)

    return one(params) if params.ndim == 1 else torch.stack([one(p) for p in params])


def table_gather(name, tables, pixels):
    """The flat gather of every scalar of the table rows at `pixels`: tables
    (..., H*W, 8) flattened, pixels (..., H*W) int64, one index per scalar:
    idx[k*H*W + p, ch] = (k*H*W + pixels[k, p]) * 8 + ch, as (rows, 8) int32."""
    hw, c = tables.shape[-2:]
    pix = pixels.reshape(-1, hw)
    pix = pix + torch.arange(pix.shape[0], device=pix.device)[:, None] * hw
    idx = (pix.reshape(-1, 1) * c + torch.arange(c, device=pix.device)).to(torch.int32).contiguous()
    return _flat(name, tables.reshape(-1), idx, c)


def aligner_gathers(cur_packed, table, params, projector, candidates=(), seed=0):
    """Part (b)'s gathers: identity, projective and random over the (H*W, 8)
    reference table, then the projective pattern over each entry
    (cur_packed, tables (K, H*W, 8), params (K, 24), projector) of
    `candidates`."""
    hw, dev = table.shape[0], table.device
    size = f"{projector.cols}x{projector.rows}"
    perm = torch.as_tensor(np.random.default_rng(seed).permutation(hw), device=dev)
    gathers = [
        table_gather(f"{size} identity", table, torch.arange(hw, device=dev)),
        table_gather(f"{size} projective", table, projective_pixels(cur_packed, params, projector)),
        table_gather(f"{size} random", table, perm),
    ]
    for cur_k, tables, params_k, proj_k in candidates:
        gathers.append(table_gather(f"{proj_k.cols}x{proj_k.rows} projective, K={tables.shape[0]} tables", tables,
                                    projective_pixels(cur_k, params_k, proj_k)))
    return gathers


# -- (c) kernel 2's gather in its own pattern, without its arithmetic -------------------


def fetched_rows(cur_packed, params, projector):
    """The distinct reference rows fetched by the projective gather (each
    current pixel that projects into the image fetches the row it lands on),
    summed over the candidates of params (24,) or (K, 24)."""
    valid = cur_packed[7] > 0
    rows = 0
    for p in params.reshape(-1, fa.N_PARAMS):
        inside, idx = fa.project_to_reference(cur_packed[0:3], valid, p, projector)
        rows += int(torch.unique(idx[inside]).numel())
    return rows


def system_bytes(cur_packed, params, projector, n_out):
    """The bytes that K systems on one current cloud must move: every current
    channel once, each distinct reference row fetched (32 B), the K params
    rows and `n_out` float32 outputs per system."""
    k = params.reshape(-1, fa.N_PARAMS).shape[0]
    rows = fetched_rows(cur_packed, params, projector)
    return cur_packed.numel() * 4 + rows * fa.C_REF * 4 + k * (fa.N_PARAMS + n_out) * 4


def check_traffic(cur_packed, tables, params, projector):
    """`gather_probe.projective_gather_sum` once on kernel 2's inputs, held
    equal to its plain version (two integers per candidate, so exactly).
    Prints one line; returns the output; raises CheckFailure."""
    out = gp.projective_gather_sum(cur_packed, tables, params, projector)
    ref = gp.projective_gather_sum_reference(cur_packed, tables, params, projector)
    name = f"{projector.cols}x{projector.rows} kernel 2's gather, K={tables.shape[0]}"
    if not torch.equal(out, ref):
        raise CheckFailure(f"{name}: the kernel gives {out.tolist()}, its plain version {ref.tolist()}")
    print(f"{name:44s} OK  rows fetched {out[:, 0].tolist()}, bit sums equal to the plain version's", flush=True)
    return out


def measure_traffic(cur_packed, tables, params, projector, acfg, n=20):
    """Device times by CUDA graph replays, ms per call, on kernel 2's inputs:
    `projective_gather_sum`, its plain version and kernel 2 itself, in turns
    (probe, kernel 2, kernel 2, probe; each the lesser of its two); the bound
    of the probe's bytes. Where the probe takes most of kernel 2's time,
    kernel 2 is bound by its memory traffic; the rest is its arithmetic and
    its 29-sum reduction."""
    def probe():
        return gp.projective_gather_sum(cur_packed, tables, params, projector)

    def kernel2():
        return fa.fused_system_batch(cur_packed, tables, params, projector, acfg)

    k2_ms, probe_ms = in_turns(kernel2, probe, cur_packed, n)
    n_bytes = system_bytes(cur_packed, params, projector, 2)
    bound_ms, _ = bound(n_bytes)
    m = {
        "ms": probe_ms,
        "plain_ms": graph_ms(lambda: gp.projective_gather_sum_reference(cur_packed, tables, params, projector),
                             cur_packed, 4),
        "kernel2_ms": k2_ms,
        "bound_ms": bound_ms,
        "bytes": n_bytes,
    }
    print(f"{'':44s} device ms (CUDA graph replays): probe {probe_ms:.6f}, kernel 2 {k2_ms:.6f} (kernel 2 takes "
          f"{k2_ms / probe_ms:.2f}x its loads alone), plain {m['plain_ms']:.6f}; bound {bound_ms:.6f} ({n_bytes} B); "
          f"{n_bytes / probe_ms / 1e6:.1f} GB/s, {100 * bound_ms / probe_ms:.2f}% of the bound", flush=True)
    return m


# -- the command line -----------------------------------------------------------------


def _parser():
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", help="torch device of the probes")
    return ap


def run(argv=None) -> dict:
    """Parse `argv`, run parts (a), (b) and (c); returns the result dict."""
    args = _parser().parse_args(argv)
    device = torch.device(args.device)
    on_card = device.type == "cuda"
    result = {"device": str(device), "probes": [], "widths": []}
    if on_card:
        result["card"] = gpu_name_and_power_limit()
        print(result["card"], flush=True)
    for g in tpu_probes(device):
        out, _ = check(g)
        entry = {"name": g.name, "replaces": g.replaces, "out": out.reshape(-1)[:4].tolist()}
        if on_card:
            entry.update(measure(g))
        result["probes"].append(entry)
    for g in out_of_range_probes(device):
        check(g)
    if not on_card:
        print("(b), (c) the gathers at 640x480: not measured (they measure the card; run with --device cuda)")
        return result
    cur_packed, table, params, tables, params_k, proj = bench_tables(synth.K_CANDIDATES, device)
    for g in aligner_gathers(cur_packed, table, params, proj, [(cur_packed, tables, params_k, proj)]):
        check(g)
        result["widths"].append({"name": g.name, **measure(g, n=20)})
    check_traffic(cur_packed, tables, params_k, proj)
    result["kernel2_gather"] = measure_traffic(cur_packed, tables, params_k, proj, AlignerConfig())
    return result


def main(argv=None):
    print(json.dumps(run(argv)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
