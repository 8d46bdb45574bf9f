"""The share of the traced window in which no operation ran on the card,
in percent: 100 (1 - busy / window), busy the union of kernels, copies
and fills in the profiler's trace."""


def read(r):
    busy = r.trace.busy_s
    return 100.0 * (1.0 - busy / r.window_s) if r.window_s > 0 and busy > 0 else None
