"""Each cell driven end to end on the CPU at the small size (the plain
path: the program's CPU tensors take its plain PyTorch versions), the
measurement path's refusal without a card, and the judge's teeth: the
control (the reference in TF32 in the program's place) and a timed path
broken underneath come out not correct."""
import time

import numpy as np
import pytest
import torch

from perfbench import harness, run as bench_run, small

CELLS = ["pwn_odom.live", "se2_schur.victoria", "pwn_odom.offline", "se2_dense.victoria"]


def drive(workload, seed=5, seconds=1.0, trace=0, broken=None):
    """The run's result and checks; `broken(run, state)` breaks the timed
    path after set-up and returns the function that mends it."""
    run, bench = small.make_run(workload, seed=seed, seconds=seconds, trace=trace)
    drv = harness.driver(run.traffic["driver"])
    setup = drv.setup
    mend = []

    def setup_and_break(r):
        st = setup(r)
        if broken:
            mend.append(broken(r, st))
        return st

    drv.setup = setup_and_break
    try:
        return bench_run.execute(run, bench, time.perf_counter())
    finally:
        drv.setup = setup
        for m in mend:
            m()


@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_correct_on_the_cpu(workload):
    result, checks = drive(workload)
    assert result["correct"], [(c.name, c.value, c.limit) for c in checks if not c.ok]
    assert result["attempted"] >= 1 and result["failed"] == 0
    names = {m["name"] for m in harness.metrics_of(harness.benchmark(), "end_to_end", workload)}
    assert set(result["metrics"]) == names and all(v["value"] > 0 for v in result["metrics"].values())


def test_traced_run_reports_per_layer_counters_on_the_cpu():
    result, _ = drive("se2_schur.victoria", trace=1)
    assert result["correct"] and set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert result["metrics"]["cg_iters_per_solve"]["value"] > 0
    assert "busy_s" in result["device"] and "window_s" in result["device"]


def test_measurement_path_refuses_a_run_without_a_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_run.main(["--workload", "pwn_odom.live", "--seed", "1", "--seconds", "1"]) == 3
    out = capsys.readouterr()
    assert out.out == "" and "no run" in out.err


@pytest.mark.parametrize("workload", CELLS)
def test_control_in_tf32_is_not_correct(workload):
    # the reference runs eagerly in the program's place: a longer window
    # gives the live tracker's judge its frames
    result, checks = drive(workload, seconds=4.0,
                           broken=lambda run, st: harness.driver(run.traffic["driver"]).control(run, st))
    assert not result["correct"], [(c.name, c.value, c.limit) for c in checks]


def _pwn_align(transform):
    """Break the tracker's aligner: its result's T passed through `transform`."""
    def broken(run, st):
        mod, align = st.module, st.module.align

        def wrong(r, cur, projector, guess, config):
            res = align(r, cur, projector, guess, config)
            return res._replace(T=transform(res.T, torch.as_tensor(guess, dtype=res.T.dtype)))

        mod.align = wrong
        return lambda: setattr(mod, "align", align)
    return broken


def _half_pixels(attr):
    """Break the converter: every other image row left out."""
    def broken(run, st):
        mod, convert = st.module, getattr(st.module, attr)

        def half(depth, *args):
            depth = depth.clone()
            depth[1::2] = 0.0
            return convert(depth, *args)

        setattr(mod, attr, half)
        return lambda: setattr(mod, attr, convert)
    return broken


def _scan_output(transform):
    def broken(run, st):
        scan = st.scan

        def wrong(*args, **kwargs):
            traj, metrics = scan(*args, **kwargs)
            return transform(traj), metrics

        st.scan = wrong
        return lambda: setattr(st, "scan", scan)
    return broken


def _shift(T):
    T = T.clone()
    T[..., 0, 3] += 5e-3
    return T


def _solve_output(transform):
    def broken(run, st):
        solve = st.solve

        def wrong(g):
            out, stats = solve(g)
            return transform(g, out), stats

        st.solve = wrong
        return lambda: setattr(st, "solve", solve)
    return broken


def _perturbed(g, out):
    noise = torch.from_numpy(np.random.default_rng(0).normal(0, 0.05, tuple(out.poses.shape))).to(out.poses.dtype)
    return out.with_poses(out.poses + noise, out.landmarks)


FAULTS = {
    "pwn_odom.live": {
        "state unchanged": _pwn_align(lambda T, guess: guess),
        "answer altered": _pwn_align(lambda T, guess: _shift(T)),
        "half the pixels left out": _half_pixels("depth_to_cloud"),
    },
    "pwn_odom.offline": {
        "state unchanged": _scan_output(lambda traj: traj[:1].expand_as(traj).clone()),
        "answer altered": _scan_output(_shift),
        "half the pixels left out": _half_pixels("_depth_to_cloud"),
    },
    "se2_schur.victoria": {
        "state unchanged": _solve_output(lambda g, out: g),
        "answer altered": _solve_output(_perturbed),
    },
    "se2_dense.victoria": {
        "state unchanged": _solve_output(lambda g, out: g),
        "answer altered": _solve_output(_perturbed),
    },
}


@pytest.mark.parametrize("workload,fault", [(w, f) for w, fs in FAULTS.items() for f in fs])
def test_broken_timed_path_is_not_correct(workload, fault):
    result, checks = drive(workload, broken=FAULTS[workload][fault])
    assert not result["correct"], [(c.name, c.value, c.limit) for c in checks]
