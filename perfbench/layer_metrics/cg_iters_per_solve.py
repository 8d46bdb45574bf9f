"""CG iterations a solve (`SchurStats.cg_iters`), the mean over the
window's solves: work done, so a change that converges less shows."""


def read(r):
    cg = r.counters.get("cg_iters")
    return sum(cg) / len(cg) if cg else None
