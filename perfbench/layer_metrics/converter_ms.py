"""Device milliseconds a `depth_to_cloud` call: the mean device time of
the replayed converter graphs in the traced window. A graph replay is one
launch; the converter's is the one that runs the integral images'
cumulative sums (a ``scan`` kernel) and not the aligner's kernel 1."""

from perfbench import roofline


def read(r):
    ns = [n for call, n, names in r.trace.launches if call.startswith("cudaGraphLaunch")
          and any("scan" in k for k in names) and not any(roofline.is_kernel1(k) for k in names)]
    return sum(ns) / 1e6 / len(ns) if ns else None
