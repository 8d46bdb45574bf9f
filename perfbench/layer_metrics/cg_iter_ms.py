"""Milliseconds a CG iteration: the window's solve time by the host's
clock over the CG iterations the solves report (`SchurStats.cg_iters`),
of the solves that ran with the profiler off."""


def read(r):
    rows = [(t, n) for t, n, traced in zip(r.counters["solve_s"], r.counters.get("cg_iters", []), r.counters["traced"])
            if not traced]
    n = sum(n for _, n in rows)
    return 1e3 * sum(t for t, _ in rows) / n if n > 0 else None
