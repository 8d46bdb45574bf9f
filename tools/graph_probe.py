"""The captured stages (``g2o_frontend_tpu_torch/utils/graphs.py``) on the
card: each graph held bit for bit against its eager body, and the graphs
timed against the eager bodies.

1. Checks (`check_stages`, `check_fresh_outputs`, `check_other_guess`,
   `check_inline`, `check_capture_failure`; the card-only tests of
   ``tests/test_torch_graphs.py`` call them): on the bench pair
   (``utils/synth.bench_pair``) `depth_to_cloud`, `align` with each
   association and with a prior, `align_batch` over K candidates and
   `odometry_scan` over a few frames, each bit-equal to its private eager
   body on the same inputs, its launches counted as the eager body's; two
   calls return tensors that do not alias, and the first call's outputs
   survive the second; a second call with another initial guess gives the
   eager result for that guess; a call inside an enclosing capture runs
   inline; a capture that fails raises `CaptureError`.
2. Timing at 640x480 (`timing`): graph against eager in turns (eager,
   graph, graph, eager), CUDA events around whole calls, median of n
   calls: `depth_to_cloud`, `align`, `align_batch` at K = 8 and 21; the
   device time of each call by torch.profiler and the device's idle share
   of a call. Then every captured key with its capture ms, the bytes it
   added to the shared pool and its static inputs.

One JSON line per measurement. Run from the repository root on a machine
with a CUDA card (the kernels are built from the checkout):

    python3 tools/graph_probe.py [--no-timing]
"""
import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import g2o_frontend_tpu_torch  # noqa: E402,F401  (turns TF32 off)
from g2o_frontend_tpu_torch.ops import fused_aligner as fa  # noqa: E402
from g2o_frontend_tpu_torch.ops import linearizer as lin  # noqa: E402
from g2o_frontend_tpu_torch.pwn import aligner as al  # noqa: E402
from g2o_frontend_tpu_torch.pwn import converter as cv  # noqa: E402
from g2o_frontend_tpu_torch.slam import pwn_tracker as pt  # noqa: E402
from g2o_frontend_tpu_torch.slam.pwn_matcher import stack_clouds  # noqa: E402
from g2o_frontend_tpu_torch.utils import graphs, lie, synth  # noqa: E402
from g2o_frontend_tpu_torch.utils.profiling import CheckFailure, gpu_name_and_power_limit  # noqa: E402


def leaves(x):
    """The tensors of a tree of tuples, NamedTuples, lists and dicts."""
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in leaves(x[k])]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in leaves(v)]
    return [x] if isinstance(x, torch.Tensor) else []


def same_bits(a, b):
    """Two trees of tensors equal bit for bit (shapes, dtypes and bytes)."""
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and x.dtype == y.dtype and x.cpu().contiguous().numpy().tobytes()
        == y.cpu().contiguous().numpy().tobytes() for x, y in zip(la, lb))


def check(cond, msg):
    if not cond:
        raise CheckFailure(msg)


def counts():
    return fa.launches, fa.batch_launches, lin.launches


def grew(fn):
    """(fn(), the launches of kernels 1, 2 and 3 it made)."""
    c0 = counts()
    out = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out, tuple(b - a for a, b in zip(c0, counts()))


def inputs(device, H=480, W=640, K=8):
    """The bench pair's depths, projector, configs and ground truth, and K
    candidate references rendered around the identity with their guesses."""
    d_ref, d_cur, proj, T_gt = synth.bench_pair(device, H, W)
    ccfg = cv.ConverterConfig() if H >= 240 else cv.ConverterConfig(min_image_radius=3, max_image_radius=8,
                                                                     min_points=12)
    poses = synth.candidate_poses(K)
    refs = stack_clouds([cv.depth_to_cloud(synth.bench_depth(P, device, H, W), proj, ccfg) for P in poses])
    guesses = torch.as_tensor(np.linalg.inv(poses), dtype=torch.float32, device=device)
    return dict(d_ref=d_ref, d_cur=d_cur, proj=proj, T_gt=T_gt, ccfg=ccfg, acfg=al.AlignerConfig(), refs=refs,
                guesses=guesses, ref=cv.depth_to_cloud(d_ref, proj, ccfg), cur=cv.depth_to_cloud(d_cur, proj, ccfg))


def check_stages(x, scan_frames=4, zbuffer_k=2, errors=None):
    """Every stage on `x` (from `inputs`): the graph's outputs (second call
    of its key) bit-equal to the eager body's, and its launches equal.
    Returns {stage: (launches of kernels 1, 2, 3 a call)}. With a list
    `errors`, a case that raises is recorded there and the others go on."""
    proj, ccfg, acfg = x["proj"], x["ccfg"], x["acfg"]
    guess = torch.as_tensor(np.linalg.inv(x["T_gt"]), dtype=torch.float32, device=x["d_ref"].device)
    prior = al.absolute_prior(torch.eye(4, device=guess.device), guess, 10.0 * torch.eye(6, device=guess.device))
    zcfg = al.AlignerConfig(association="zbuffer")
    cases = {
        "depth_to_cloud": (lambda: cv.depth_to_cloud(x["d_cur"], proj, ccfg),
                           lambda: cv._depth_to_cloud(x["d_cur"], proj, ccfg, None)),
        "align": (lambda: al.align(x["ref"], x["cur"], proj, config=acfg),
                  lambda: al._align(x["ref"], x["cur"], proj, None, acfg, None)),
        "align, guess": (lambda: al.align(x["ref"], x["cur"], proj, guess.cpu().numpy(), acfg),
                         lambda: al._align(x["ref"], x["cur"], proj, guess, acfg, None)),
        "align, gather": (lambda: al.align(x["ref"], x["cur"], proj, config=al.AlignerConfig(association="gather")),
                          lambda: al._align(x["ref"], x["cur"], proj, None, al.AlignerConfig(association="gather"),
                                            None)),
        "align, zbuffer": (lambda: al.align(x["ref"], x["cur"], proj, config=zcfg),
                           lambda: al._align(x["ref"], x["cur"], proj, None, zcfg, None)),
        "align, prior": (lambda: al.align(x["ref"], x["cur"], proj, guess, acfg, prior),
                         lambda: al._align(x["ref"], x["cur"], proj, guess, acfg, prior)),
        "align_batch": (lambda: al.align_batch(x["refs"], x["cur"], proj, x["guesses"], acfg),
                        lambda: al._align_batch(x["refs"], x["cur"], proj, x["guesses"], acfg)),
        "align_batch, zbuffer": (
            lambda: al.align_batch(sub(x["refs"], zbuffer_k), x["cur"], proj, x["guesses"][:zbuffer_k], zcfg),
            lambda: al._align_batch(sub(x["refs"], zbuffer_k), x["cur"], proj, x["guesses"][:zbuffer_k], zcfg)),
    }
    depths = torch.stack([x["d_ref"] * (1.0 + 0.002 * k) for k in range(scan_frames)])
    cases["odometry_scan"] = (lambda: pt.odometry_scan(depths, proj, ccfg, acfg, device=depths.device),
                              lambda: eager_scan(depths, proj, ccfg, acfg))
    out = {}
    for name, (graphed, eager) in cases.items():
        try:
            graphed()  # captures the key
            g, n_g = grew(graphed)
            e, n_e = grew(eager)
            check(same_bits(g, e), f"{name}: the graph's outputs differ from the eager body's")
            check(n_g == n_e, f"{name}: the graph counted launches {n_g}, the eager body {n_e}")
            out[name] = n_g
        except (CheckFailure, RuntimeError) as exc:
            if errors is None:
                raise
            errors.append(f"{name}: {type(exc).__name__}: {exc}")
    return out


def sub(cloud, k):
    return type(cloud)(*(f[:k] for f in cloud))


def eager_scan(depths, proj, ccfg, acfg, kf_fraction=0.4, min_cloud_inliers=3000):
    """`odometry_scan` with its stages run eagerly: the reference that its
    graphs are held to."""
    eye = torch.eye(4, dtype=torch.float32, device=depths.device)
    ref = cv._depth_to_cloud(depths[0], proj, ccfg, None)
    _, outs = graphs.iterate(pt._scan_step, (ref, eye, eye), depths[1:], proj, ccfg, acfg, kf_fraction,
                             min_cloud_inliers)
    return pt.scan_outputs(eye, outs)


def check_fresh_outputs(x):
    """Two calls in a row of `align` and `depth_to_cloud` (other inputs
    each time) return tensors that share no storage, and the first
    call's outputs keep their values after the second."""
    proj, ccfg, acfg = x["proj"], x["ccfg"], x["acfg"]
    for name, first, second in (
        ("depth_to_cloud", lambda: cv.depth_to_cloud(x["d_ref"], proj, ccfg),
         lambda: cv.depth_to_cloud(x["d_cur"], proj, ccfg)),
        ("align", lambda: al.align(x["ref"], x["cur"], proj, None, acfg),
         lambda: al.align(x["cur"], x["ref"], proj, None, acfg)),
    ):
        a = first()
        kept = [t.clone() for t in leaves(a)]
        b = second()
        ptrs = {t.untyped_storage().data_ptr() for t in leaves(a)}
        check(not ptrs & {t.untyped_storage().data_ptr() for t in leaves(b)}, f"{name}: two calls share storage")
        check(same_bits(kept, leaves(a)), f"{name}: the second call changed the first call's outputs")


def check_other_guess(x):
    """align with one initial guess, then another: each equals the eager
    body for its guess."""
    proj, acfg = x["proj"], x["acfg"]
    dev = x["d_ref"].device
    for T in (np.eye(4), np.linalg.inv(x["T_gt"]), lie.se3_exp(torch.tensor([0.02, 0.0, 0.01, 0.0, 0.02, 0.0]))
              .double().numpy()):
        g = al.align(x["ref"], x["cur"], proj, T.astype(np.float32), acfg)
        e = al._align(x["ref"], x["cur"], proj, torch.as_tensor(T, dtype=torch.float32, device=dev), acfg, None)
        check(same_bits(g, e), "align with another initial guess differs from the eager body")


def check_inline(x):
    """`align` called inside an enclosing capture runs inline: no key is
    captured, and the enclosing graph's replay gives the eager result."""
    proj, acfg = x["proj"], x["acfg"]
    n = len(graphs.captures())
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        al.align(x["ref"], x["cur"], proj, None, acfg)  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    outer = torch.cuda.CUDAGraph()
    with torch.cuda.graph(outer):
        res = al.align(x["ref"], x["cur"], proj, None, acfg)
    check(len(graphs.captures()) == n, "a call inside an enclosing capture captured a graph of its own")
    outer.replay()
    torch.cuda.synchronize()
    check(same_bits(res, al._align(x["ref"], x["cur"], proj, None, acfg, None)),
          "the enclosing graph's align differs from the eager body")


def check_capture_failure(x):
    """A stage whose body reads the host cannot be captured: the call
    raises `CaptureError`, naming the stage and the line, and caches
    nothing."""

    def reads_the_host(depth):
        return depth * float(depth.sum())

    stage = graphs.Stage("reads the host", reads_the_host)
    try:
        stage(x["d_ref"])
    except graphs.CaptureError as exc:
        check("reads the host" in str(exc) and "in reads_the_host" in str(exc), f"the error names no line: {exc}")
        check(not stage._graphs, "a failed capture was cached")
        return str(exc)
    raise CheckFailure("a body that reads the host was captured without an error")


def turns(name, graphed, eager, n):
    """Graph and eager in turns (eager, graph, graph, eager), each the
    median ms of n whole calls by CUDA events; device ms by torch.profiler
    and the device's idle share of a call."""
    from g2o_frontend_tpu_torch.utils.profiling import device_ms, event_ms

    e1, g1, g2, e2 = (float(np.median(event_ms(f, n))) for f in (eager, graphed, graphed, eager))
    row = {"stage": name, "graph_ms": min(g1, g2), "eager_ms": min(e1, e2), "graph_runs_ms": [g1, g2],
           "eager_runs_ms": [e1, e2], "eager_device_ms": device_ms(eager, 5)}
    try:
        row["graph_device_ms"] = device_ms(graphed, 5)
    except RuntimeError:  # the profiler saw no kernel of the replays
        row["graph_device_ms"] = None
    row["speedup"] = row["eager_ms"] / row["graph_ms"]
    row["graph_idle_share"] = 1.0 - (row["graph_device_ms"] or row["eager_device_ms"]) / row["graph_ms"]
    row["eager_idle_share"] = 1.0 - row["eager_device_ms"] / row["eager_ms"]
    return row


def timing(device, n=20):
    """The four stages at 640x480, graph against eager (`turns`)."""
    x = inputs(device, K=21)
    proj, ccfg, acfg = x["proj"], x["ccfg"], x["acfg"]
    rows = [turns("depth_to_cloud", lambda: cv.depth_to_cloud(x["d_cur"], proj, ccfg),
                  lambda: cv._depth_to_cloud(x["d_cur"], proj, ccfg, None), n),
            turns("align", lambda: al.align(x["ref"], x["cur"], proj, None, acfg),
                  lambda: al._align(x["ref"], x["cur"], proj, None, acfg, None), n)]
    for K in (8, 21):
        refs, guesses = sub(x["refs"], K), x["guesses"][:K]
        rows.append(turns(f"align_batch K={K}", lambda: al.align_batch(refs, x["cur"], proj, guesses, acfg),
                          lambda: al._align_batch(refs, x["cur"], proj, guesses, acfg), max(n // 2, 5)))
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--no-timing", action="store_true", help="run the checks only")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("graph_probe: no CUDA device", file=sys.stderr)
        return 2
    smi = gpu_name_and_power_limit()
    print(smi, flush=True)
    device = torch.device("cuda:0")
    errors = []
    for H, W in ((120, 160), (480, 640)):
        x = inputs(device, H, W)
        launches = check_stages(x, errors=errors)
        for fn in (check_fresh_outputs, check_other_guess, check_inline):
            try:
                fn(x)
            except (CheckFailure, RuntimeError) as exc:
                errors.append(f"{fn.__name__}: {type(exc).__name__}: {exc}")
        print(json.dumps({"checks": f"{H}x{W}", "launches": launches, "errors": errors}), flush=True)
    print(json.dumps({"capture_failure": check_capture_failure(x)}), flush=True)
    if not args.no_timing:
        for row in timing(device):
            print(json.dumps({**row, "gpu": smi}), flush=True)
    for c in graphs.captures():
        print(json.dumps({"capture": c.stage, "shapes": c.shapes, "capture_ms": c.capture_ms,
                          "pool_bytes": c.pool_bytes, "input_bytes": c.input_bytes, "launches": c.launches}),
              flush=True)
    print(smi, flush=True)
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
