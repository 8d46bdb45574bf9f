"""Host reads a solve: `utils.graphs.host_reads` across each solve of the
window, the mean."""


def read(r):
    reads = r.counters.get("host_reads")
    return sum(reads) / len(reads) if reads else None
