"""TUM RGB-D dataset IO + trajectory format (pwn_odometry protocol).

The reference's odometry/benchmark apps consume TUM-style sequences and emit
`timestamp x y z qx qy qz qw` trajectories for external ATE evaluation
(``pwn_odometry/pwn_odometry.cpp:27-46``, ``pwn/pwn_benchmark.cpp:417-421``).
This module provides:

- `read_depth_index` / `load_depth`: the `depth.txt` index + 16-bit PNG
  depth images (scale 1/5000 m) of TUM sequences,
- `read_trajectory` / `write_trajectory`: the TUM trajectory format,
- `associate`: timestamp association between two indexes (the benchmark
  `associate.py` convention, max_difference default 0.02 s).

PNG decoding uses a minimal pure-python 16-bit grayscale reader (zlib) — no
OpenCV dependency (the reference needs OpenCV for this, ``pwn_boss`` image
BLOBs); falls back to torch/PIL if the PNG uses exotic filters.

The port's own copy of ``g2o_frontend_tpu/io/tum.py`` (numpy only): the
port imports nothing of the JAX package, so the two copies are kept equal
by hand.
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np

__all__ = [
    "read_depth_index",
    "load_depth_png",
    "read_trajectory",
    "write_trajectory",
    "associate",
    "kinect_presets",
]

# fx, fy, cx, cy per TUM sequence family (pwn_odometry.cpp:42 sensor presets)
kinect_presets = {
    "kinectFreiburg1": (517.3, 516.5, 318.6, 255.3),
    "kinectFreiburg2": (520.9, 521.0, 325.1, 249.7),
    "kinectFreiburg3": (535.4, 539.2, 320.1, 247.6),
    "kinect": (525.0, 525.0, 319.5, 239.5),
}


def read_depth_index(seq_dir):
    """Parse depth.txt -> list of (timestamp, relative_path)."""
    out = []
    with open(os.path.join(seq_dir, "depth.txt")) as fh:
        for line in fh:
            if line.startswith("#") or not line.strip():
                continue
            ts, path = line.split()[:2]
            out.append((float(ts), path))
    return out


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    if pb <= pc:
        return b
    return c


def load_depth_png(path, depth_scale=1.0 / 5000.0):
    """Load a 16-bit grayscale PNG depth image -> (H, W) float32 meters."""
    raw = load_depth_png_raw(path)
    return raw.astype(np.float32) * depth_scale


def load_depth_png_raw(path):
    """Load a grayscale PNG depth image as RAW uint16 counts.

    The raw form is what goes over the host->device wire in scan mode —
    half the bytes of float32, with the meters conversion done on device
    (``slam/pwn_tracker.odometry_scan(depth_scale=...)``)."""
    with open(path, "rb") as fh:
        data = fh.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG"
    pos = 8
    idat = b""
    width = height = bitdepth = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        ctype = data[pos + 4 : pos + 8]
        chunk = data[pos + 8 : pos + 8 + length]
        if ctype == b"IHDR":
            width, height, bitdepth, color, comp, filt, interlace = struct.unpack(
                ">IIBBBBB", chunk
            )
            assert color == 0, "depth PNG must be grayscale"
            assert interlace == 0
        elif ctype == b"IDAT":
            idat += chunk
        elif ctype == b"IEND":
            break
        pos += 12 + length
    raw = zlib.decompress(idat)
    bpp = 2 if bitdepth == 16 else 1
    stride = width * bpp
    img = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    off = 0
    for y in range(height):
        ftype = raw[off]
        line = np.frombuffer(raw[off + 1 : off + 1 + stride], np.uint8).astype(
            np.int32
        )
        off += 1 + stride
        if ftype == 0:
            cur = line
        elif ftype == 1:  # sub
            cur = line.copy()
            for x in range(bpp, stride):
                cur[x] = (cur[x] + cur[x - bpp]) & 0xFF
        elif ftype == 2:  # up
            cur = (line + prev) & 0xFF
        elif ftype == 3:  # average
            cur = line.copy()
            for x in range(stride):
                left = cur[x - bpp] if x >= bpp else 0
                cur[x] = (cur[x] + ((left + prev[x]) >> 1)) & 0xFF
        elif ftype == 4:  # paeth
            cur = line.copy()
            for x in range(stride):
                left = cur[x - bpp] if x >= bpp else 0
                ul = prev[x - bpp] if x >= bpp else 0
                cur[x] = (cur[x] + _paeth(left, prev[x], ul)) & 0xFF
        else:
            raise ValueError(f"bad PNG filter {ftype}")
        img[y] = cur.astype(np.uint8)
        prev = cur
    if bitdepth == 16:
        return (img[:, 0::2].astype(np.uint16) << 8) | img[:, 1::2]
    return img.astype(np.uint16)


def read_trajectory(path):
    """-> (timestamps (N,), poses7 (N, 7) [t, qx qy qz qw])."""
    ts, poses = [], []
    with open(path) as fh:
        for line in fh:
            if line.startswith("#") or not line.strip():
                continue
            v = [float(x) for x in line.split()]
            ts.append(v[0])
            poses.append(v[1:8])
    return np.asarray(ts), np.asarray(poses)


def write_trajectory(path, timestamps, poses7):
    """Write TUM format `ts x y z qx qy qz qw` (pwn_odometry.cpp:43-46)."""
    with open(path, "w") as fh:
        for t, p in zip(timestamps, poses7):
            fh.write(
                f"{t:.6f} "
                + " ".join(f"{float(x):.6f}" for x in p[:7])
                + "\n"
            )


def associate(ts_a, ts_b, max_difference=0.02):
    """Greedy nearest-timestamp association -> list of (ia, ib)."""
    ts_a = np.asarray(ts_a)
    ts_b = np.asarray(ts_b)
    pairs = []
    used_b = set()
    for ia, ta in enumerate(ts_a):
        ib = int(np.argmin(np.abs(ts_b - ta)))
        if ib in used_b:
            continue
        if abs(ts_b[ib] - ta) <= max_difference:
            pairs.append((ia, ib))
            used_b.add(ib)
    return pairs
