"""The PWN SLAM cell (`pwn_slam.fr1_loop`) on the CPU at the small size: its
driver and judge run correct, and each fault planted in the timed path,
and the control (the reference in TF32 in the program's place), come out
not correct, each by the check that should catch it.

The small size is `small.config`'s (a quarter of the resolution, a 60-frame
lap, the limits `small.LIMIT_FACTOR` wider) with the closer's frame gates
scaled by the image's area as its radii are, a lap of set-up, two
buckets, a short warm-up, and consensus after one check (at three, a few
seconds of CPU frames commit nothing). The map solve's limits are not
widened: its gaps come from the solve's float32 iterations, not from the
image's size."""
import dataclasses
import time

import numpy as np
import pytest
import torch

from perfbench import harness, roofline, roofline_batch, small
from perfbench import run as bench_run

CELL = "pwn_slam.fr1_loop"


def make_run(seed=5, seconds=8.0, trace=0):
    run, bench = small.make_run(CELL, seed=seed, seconds=seconds, trace=trace)
    cl = run.config["closer"]
    for k in ("frame_min_nonzero_threshold", "frame_max_outliers_threshold", "frame_min_inliers_threshold"):
        cl[k] = cl[k] // 16
    cl["consensus_min_times_checked"] = 1
    # the map solve's numbers do not grow at the small size: its limits as they are
    run.limits.update({k: v for k, v in harness.limits(CELL).items() if k.startswith("map_")})
    lap = run.config["sequence"]["frames"]
    run.traffic = dict(run.traffic, prime_frames=lap, last_frame=2 * lap, buckets=[8, 16],
                       max_window_keyframes=4, max_window_closures=4, judge_frames=6, judge_batches=4,
                       judge_candidates=2, judge_solves=8)
    return run, bench


def drive(seed=5, seconds=8.0, trace=0, broken=None):
    """The run's result and checks; `broken(run, state)` breaks the timed
    path after set-up and returns the function that mends it."""
    run, bench = make_run(seed, seconds, trace)
    drv = harness.driver(run.traffic["driver"])
    setup, mend = drv.setup, []

    def setup_and_break(r):
        st = setup(r)
        if broken:
            mend.append(broken(r, st))
        return st

    drv.setup = setup_and_break
    try:
        result, checks = bench_run.execute(run, bench, time.perf_counter())
    finally:
        drv.setup = setup
        for m in mend:
            m()
    return result, {c.name: c for c in checks}, run


def failed(checks):
    return sorted(n for n, c in checks.items() if not c.ok)


def test_cell_runs_correct_on_the_cpu():
    result, checks, run = drive()
    assert result["correct"], [(c.name, c.value, c.limit) for c in checks.values() if not c.ok]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"frames_per_s", "frame_ms_p95", "setup_s"}
    c = run.counters
    assert c["committed"] >= 1 and c["map_solves"] >= 1 and c["batches"] >= 1
    assert c["window_captures"] == 0  # the CPU captures nothing
    assert sum(c["k_real"].values()) == sum(c["k_padded"].values()) == c["batches"]
    assert set(c["k_padded"]) <= {8, 16}


def _closer_output(transform):
    """Break the closer's batch matcher: its results passed through `transform`."""
    def broken(run, st):
        mod = st.closer
        match = mod.match_clouds_batch

        def wrong(*args):
            return transform(match(*args))

        mod.match_clouds_batch = wrong
        return lambda: setattr(mod, "match_clouds_batch", match)
    return broken


def _shifted(res):
    T = res.transform.clone()
    T[..., 0, 3] += 0.1
    return res._replace(transform=T)


def _closer_config(**changes):
    def broken(run, st):
        closer = st.slam.closer
        cfg = closer.cfg
        closer.cfg = dataclasses.replace(cfg, **changes)
        return lambda: setattr(closer, "cfg", cfg)
    return broken


def _map_solve(change):
    """Break the map solve: the graph or the iterations it is given changed
    by `change(g, kwargs)` in the reflector's calls of `optimize_se3`."""
    def broken(run, st):
        mod = st.reflector
        solve = mod.optimize_se3

        def wrong(g, **kwargs):
            g, kwargs = change(g, kwargs)
            return solve(g, **kwargs)

        mod.optimize_se3 = wrong
        return lambda: setattr(mod, "optimize_se3", solve)
    return broken


def _drop_a_closure(g, kwargs):
    ij = g.pp_ij
    closure = (ij[:, 1] != ij[:, 0] + 1) & g.pp_mask
    mask = g.pp_mask.clone()
    if bool(closure.any()):
        mask[int(torch.nonzero(closure)[-1])] = False
    return dataclasses.replace(g, pp_mask=mask), kwargs


def _swap_blocks(g, kwargs):
    # a plain transpose leaves every (symmetric) information matrix as it
    # is: exchange its translation and rotation blocks instead
    order = torch.tensor([3, 4, 5, 0, 1, 2], device=g.pp_info.device)
    return dataclasses.replace(g, pp_info=g.pp_info[:, order][:, :, order]), kwargs


def _one_iteration(g, kwargs):
    return g, dict(kwargs, iters=1)


MAP = ("map_chi2_gap", "map_position_gap_m")

# each fault, and the checks of which at least one must catch it
FAULTS = {
    "perturbed closure transform": (_closer_output(_shifted), ("closure_overlap_gap_p90",)),
    "flipped gate": (_closer_config(frame_max_outliers_threshold=0), ("gate_flips",)),
    "dropped accepted closure": (_map_solve(_drop_a_closure), MAP),
    "exchanged information blocks": (_map_solve(_swap_blocks), MAP),
    "map solve stopped after one iteration": (_map_solve(_one_iteration), MAP),
    "window with no commit": (_closer_config(consensus_min_times_checked=10**6), ("no_closure",)),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_fault_is_not_correct(fault):
    broken, catch = FAULTS[fault]
    result, checks, _ = drive(broken=broken)
    assert not result["correct"] and set(catch) & set(failed(checks)), (catch, failed(checks))


def test_control_in_tf32_is_not_correct():
    result, checks, _ = drive(seconds=12.0, broken=lambda run, st: harness.driver(run.traffic["driver"]).control(
        run, st))
    assert not result["correct"], [(c.name, c.value, c.limit) for c in checks.values()]


def test_traced_run_reads_the_program_readers_on_the_cpu():
    result, _, run = drive(seconds=4.0, trace=1)
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    # the device readers find no card; the program's spans and counters do
    assert "closer_recomputes_per_call" in result["metrics"]
    assert run.counters["align_batch_device_ms"] == [] and run.counters["kernel2_ns"] == []


def test_kernel2_bytes_count_every_input_once():
    cur = 4 * 480 * 640 * roofline.CUR_CHANNELS
    for k in (8, 21, 128):
        b = roofline_batch.kernel2_bytes(k, 480, 640)
        assert b == cur + 4 * k * (480 * 640 * roofline.REF_CHANNELS + roofline.PARAMS + roofline.SUMS)
    # with the rows a launch fetched, the count of `apps/profile_gather.system_bytes`
    rows = 4_690_000
    assert roofline_batch.kernel2_bytes(21, 480, 640, rows) == cur + 32 * rows + 4 * 21 * (24 + 29)
    # at K = 1 a launch is kernel 1's
    assert roofline_batch.kernel2_bytes(1, 480, 640) == roofline.kernel1_bytes(480, 640)
    assert roofline_batch.kernel2_bound_s(128, 480, 640) == pytest.approx(
        max(roofline_batch.kernel2_bytes(128, 480, 640) / roofline.HBM_BYTES_PER_S,
            128 * 480 * 640 * roofline.OPS_PER_PIXEL / roofline.F32_OPS_PER_S))
    assert np.isfinite(roofline_batch.kernel2_bound_s(8, 480, 640))


def _match(nz, inl):
    from perfbench.reference import pwn_slam as ref_slam

    t = torch.tensor
    return ref_slam.Match(torch.eye(4), torch.eye(6), t(inl), t(nz), t(inl), t(nz - inl))


# (the program passed, the float32 reference's (nonzeros, inliers), the
# float64 reference's, the verdict); gates 50,000 / 150,000 / 50,000
GATE_CASES = {
    "agreed": (True, (80_000, 60_000), None, None),
    "flipped": (False, (80_000, 60_000), (80_100, 60_050), "flip"),
    "near a gate": (False, (80_000, 50_100), None, None),
    "the references part": (False, (79_212, 64_374), (108_155, 24_481), "unsettled"),
    "float64 near a gate": (True, (80_000, 30_000), (80_000, 49_900), "unsettled"),
}


@pytest.mark.parametrize("case", list(GATE_CASES))
def test_gate_verdict(case):
    """A gate flip is counted only where both references, each outside the
    band, decide against the program; the float64 match is made only then."""
    from perfbench.drivers import pwn_slam as drv

    port, m32, m64, want = GATE_CASES[case]
    ccfg = harness.load_json(harness.ROOT / "perfbench/configs/pwn_slam_tum_fr1.json")["closer"]
    made = []

    def match64():
        made.append(1)
        return _match(*m64)

    assert drv.gate_verdict(port, _match(*m32), match64, ccfg) == want
    assert len(made) == (m64 is not None)
