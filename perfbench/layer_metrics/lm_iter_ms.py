"""Milliseconds an LM iteration of the dense solver: the window's solve
time by the host's clock over the LM iterations the solves report
(`OptStats.cg_iters`, which counts them for `optimize_se2_direct`), of
the solves that ran with the profiler off."""


def read(r):
    rows = [(t, n) for t, n, traced in zip(r.counters["solve_s"], r.counters["lm_iters"], r.counters["traced"])
            if not traced]
    n = sum(n for _, n in rows)
    return 1e3 * sum(t for t, _ in rows) / n if n > 0 else None
