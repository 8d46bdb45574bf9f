"""Device milliseconds an `align` call: the mean device time of the
replayed aligner graphs in the traced window. A graph replay is one
launch; the aligner's is the one that runs kernel 1
(``fused_aligner_kernel``) and not the converter's cumulative sums."""

from perfbench import roofline


def read(r):
    ns = [n for call, n, names in r.trace.launches if call.startswith("cudaGraphLaunch")
          and any(roofline.is_kernel1(k) for k in names) and not any("scan" in k for k in names)]
    return sum(ns) / 1e6 / len(ns) if ns else None
