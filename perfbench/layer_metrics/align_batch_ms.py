"""Device milliseconds a closer batch: the device time of the work launched
inside each ``closer:match`` span of the traced window (the `align_batch`
graph's copies and kernels, the overlap render and the host read's copy),
the mean over the batches. The driver's judge attributes each device
activity to the span in which the runtime call that launched it started
(`drivers/pwn_slam._match_device`)."""


def read(r):
    ms = r.counters.get("align_batch_device_ms")
    return sum(ms) / len(ms) if ms else None
