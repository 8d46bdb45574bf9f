"""The 500-frame stress run (`evaluate.pwn_slam_long`, without the cloud
cache, as `chip_smoke.py` gates it) with the converter's integral image
summed in a chosen precision. It tells a difference between
the card's run and the CPU's that comes from the scan's rounding from one
that does not.

`torch.cumsum` accumulates float32 in float64 on the CPU and in float32 on
the card, so the two devices' summed-area tables, and with them the
windowed normals, differ in their last digits, and a keyframe decision at
its threshold can go either way. `--scan`:

- `device`: the device's own `torch.cumsum` (what the port runs);
- `float64`: each axis summed in float64 and rounded to float32, which is
  the CPU's table on any device;
- `float32`: each axis summed in float32 in a parallel scan's order
  (Hillis-Steele), a table like the card's on any device.

Prints one JSON line: the protocol's figures, the scan and the device.

    python -m g2o_frontend_tpu_torch.apps.scan_witness --scan float64
    python -m g2o_frontend_tpu_torch.apps.scan_witness --scan float32 --device cpu
"""
from __future__ import annotations

import argparse
import contextlib
import json

import torch
import torch.nn.functional as F

from ..ops import integral_image


def _cumsum_float64(x, dim):
    return torch.cumsum(x.double(), dim).to(x.dtype)


def _cumsum_float32_parallel(x, dim):
    n, k = x.shape[dim], 1
    while k < n:
        x = x + torch.cat([torch.zeros_like(x.narrow(dim, 0, k)), x.narrow(dim, 0, n - k)], dim)
        k *= 2
    return x


SCANS = {"device": torch.cumsum, "float64": _cumsum_float64, "float32": _cumsum_float32_parallel}


def table(x, scan="device"):
    """`integral_image.integral_image_planar` of (C, H, W) `x` with the
    prefix sums of `scan`."""
    cumsum = SCANS[scan]
    return F.pad(cumsum(cumsum(x, 1), 2), (1, 0, 1, 0))


@contextlib.contextmanager
def scan_precision(scan):
    """The converter's integral images summed with `scan` inside the block."""
    original = integral_image.integral_image_planar
    integral_image.integral_image_planar = lambda x: table(x, scan)
    try:
        yield
    finally:
        integral_image.integral_image_planar = original


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scan", choices=sorted(SCANS), default="device", help="the integral image's prefix sums")
    ap.add_argument("--frames", type=int, default=500, help="frames of the stress run")
    ap.add_argument("--device", default="cuda", help="torch device of the run")
    return ap


def run(argv=None) -> dict:
    from .evaluate import pwn_slam_long

    args = _parser().parse_args(argv)
    with scan_precision(args.scan):
        out = pwn_slam_long(n_frames=args.frames, cloud_cache=False, device=args.device)
    return {"scan": args.scan, "device": args.device, **out}


def main(argv=None):
    print(json.dumps(run(argv)), flush=True)
    return 0


if __name__ == "__main__":
    main()
