"""Pure-numpy image codecs for reference-format BLOBs (the port's copy of
``g2o_frontend_tpu/io/image_codec.py``; its code is the JAX module's).

The reference encodes image BLOBs with cv::imencode/imdecode
(``boss_map/image_sensor.cpp:84-101``) using extensions chosen by pixel
format (``image_sensor.cpp:17-58``): pgm for mono8/mono16 depth, pbm/ppm
for rgb8, png for compressed logs. This module provides dependency-free
encoders/decoders so reference boss logs round-trip into numpy arrays:

- PGM (P5) 8/16-bit grayscale (netpbm: 16-bit is big-endian),
- PPM (P6) rgb8 (the reference labels CV_8UC3 "pbm"; OpenCV emits P6
  payloads for color data, so both extensions parse here),
- PNG grayscale 8/16-bit, read AND write (zlib deflate, filter 0; the
  16-bit path is the TUM depth convention, ``io/tum.py``).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np


# ---------------------------------------------------------------------------
# netpbm (PGM / PPM)
# ---------------------------------------------------------------------------


def _pnm_header(data: bytes):
    """Parse a netpbm header; returns (magic, w, h, maxval, offset)."""
    pos = 2
    vals = []
    while len(vals) < 3:
        # skip whitespace + comments
        while pos < len(data) and data[pos : pos + 1].isspace():
            pos += 1
        if data[pos : pos + 1] == b"#":
            while pos < len(data) and data[pos] != 0x0A:
                pos += 1
            continue
        start = pos
        while pos < len(data) and not data[pos : pos + 1].isspace():
            pos += 1
        vals.append(int(data[start:pos]))
    pos += 1  # single whitespace after maxval
    return data[:2], vals[0], vals[1], vals[2], pos


def decode_pgm(data: bytes) -> np.ndarray:
    """P5 -> (H, W) uint8/uint16 (big-endian 16-bit per spec)."""
    magic, w, h, maxval, off = _pnm_header(data)
    if magic != b"P5":
        raise ValueError(f"not a binary PGM: {magic!r}")
    if maxval > 255:
        img = np.frombuffer(data, ">u2", count=w * h, offset=off)
        return img.reshape(h, w).astype(np.uint16)
    return np.frombuffer(data, np.uint8, count=w * h, offset=off).reshape(h, w)


def encode_pgm(img: np.ndarray) -> bytes:
    img = np.asarray(img)
    if img.ndim != 2:
        raise ValueError("PGM is grayscale")
    if img.dtype == np.uint16:
        maxval, payload = 65535, img.astype(">u2").tobytes()
    else:
        maxval, payload = 255, img.astype(np.uint8).tobytes()
    h, w = img.shape
    return b"P5\n%d %d\n%d\n" % (w, h, maxval) + payload


def decode_ppm(data: bytes) -> np.ndarray:
    """P6 -> (H, W, 3) uint8."""
    magic, w, h, maxval, off = _pnm_header(data)
    if magic != b"P6":
        raise ValueError(f"not a binary PPM: {magic!r}")
    return np.frombuffer(data, np.uint8, count=w * h * 3, offset=off).reshape(
        h, w, 3
    )


def encode_ppm(img: np.ndarray) -> bytes:
    img = np.asarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError("PPM is (H, W, 3)")
    h, w, _ = img.shape
    return b"P6\n%d %d\n255\n" % (w, h) + img.tobytes()


# ---------------------------------------------------------------------------
# PNG (grayscale 8/16-bit)
# ---------------------------------------------------------------------------


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    out = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    return out


def decode_png_gray(data: bytes) -> np.ndarray:
    """Grayscale PNG -> (H, W) uint8/uint16 (all 5 filters supported)."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos = 8
    idat = b""
    width = height = bitdepth = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        ctype = data[pos + 4 : pos + 8]
        chunk = data[pos + 8 : pos + 8 + length]
        if ctype == b"IHDR":
            width, height, bitdepth, color, _, _, interlace = struct.unpack(
                ">IIBBBBB", chunk
            )
            if color != 0:
                raise ValueError("only grayscale PNG supported")
            if interlace != 0:
                raise ValueError("interlaced PNG unsupported")
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
        elif ftype == 2:  # up
            cur = (line + prev) & 0xFF
        elif ftype in (1, 3, 4):  # sub / average / paeth need a scan
            cur = line.copy()
            for x in range(stride):
                left = cur[x - bpp] if x >= bpp else 0
                ul = prev[x - bpp] if x >= bpp else 0
                if ftype == 1:
                    cur[x] = (cur[x] + left) & 0xFF
                elif ftype == 3:
                    cur[x] = (cur[x] + ((left + prev[x]) >> 1)) & 0xFF
                else:
                    cur[x] = (cur[x] + _paeth(left, prev[x], ul)) & 0xFF
        else:
            raise ValueError(f"bad PNG filter {ftype}")
        img[y] = cur.astype(np.uint8)
        prev = cur
    if bitdepth == 16:
        return ((img[:, 0::2].astype(np.uint16) << 8) | img[:, 1::2]).astype(
            np.uint16
        )
    return img


def encode_png_gray(img: np.ndarray) -> bytes:
    """(H, W) uint8/uint16 -> grayscale PNG (filter 0, deflate)."""
    img = np.asarray(img)
    if img.ndim != 2:
        raise ValueError("grayscale PNG is (H, W)")
    bitdepth = 16 if img.dtype == np.uint16 else 8
    h, w = img.shape
    if bitdepth == 16:
        rows = img.astype(">u2").view(np.uint8).reshape(h, w * 2)
    else:
        rows = img.astype(np.uint8)
    raw = b"".join(b"\x00" + rows[y].tobytes() for y in range(h))

    def chunk(ctype: bytes, payload: bytes) -> bytes:
        return (
            struct.pack(">I", len(payload))
            + ctype
            + payload
            + struct.pack(">I", zlib.crc32(ctype + payload) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, bitdepth, 0, 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )


# ---------------------------------------------------------------------------
# extension dispatch (the ImageBLOB::extension() table)
# ---------------------------------------------------------------------------


def decode_image(data: bytes, ext: str) -> np.ndarray:
    ext = ext.lower().lstrip(".")
    if ext == "pgm":
        return decode_pgm(data)
    if ext in ("ppm", "pbm"):
        return decode_ppm(data)
    if ext == "png":
        return decode_png_gray(data)
    raise ValueError(f"unsupported image extension: {ext}")


def encode_image(img: np.ndarray, ext: str) -> bytes:
    ext = ext.lower().lstrip(".")
    if ext == "pgm":
        return encode_pgm(img)
    if ext in ("ppm", "pbm"):
        return encode_ppm(img)
    if ext == "png":
        return encode_png_gray(img)
    raise ValueError(f"unsupported image extension: {ext}")
