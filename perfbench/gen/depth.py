"""Seeded Kinect depth sequences: a closed room of planes with boxes in it,
seen from a periodic camera path, rendered on the device in plain torch.

The sequence stands in for a TUM RGB-D Freiburg 1 recording (the PNGs are
not in the repository). What the configuration file fixes: the camera
(640x480, fr1 intrinsics), the frame count and rate, the path's mean
speeds (fr1/desk: ~0.41 m/s, ~23 deg/s), the Kinect's axial noise
sigma(z) = 1.425e-3 z^2 m (Khoshelham & Elberink 2012), quantisation to
1/5000 m counts, a dropout share and the scene (``scene_seed``: the
boxes' places and sizes). What the run's seed sets: the noise and the
dropouts. Every seed renders the same path through the same room, so the
work is the same and only the sensor's noise differs.

The path is periodic in the frame index (every motion is a harmonic of
one loop over `frames`), so cycling the frames has no seam.
"""
from __future__ import annotations

import math

import numpy as np
import torch

ROOM = (3.2, 2.6, 3.0)  # half-extents in x and y, height in z (meters)
N_BOXES = 10


# The path's shape: the ellipse's half-axes and height (m), and the
# amplitudes and harmonics of the look-direction's wobbles, before
# `camera_path` scales them to the configuration's mean speeds.
PATH = dict(a=1.5, b=1.1, h=1.35, dz=0.08,
            yaw=(math.radians(10.0), 4), pitch=(math.radians(8.0), 3), roll=(math.radians(5.0), 2))


def camera_path(seq, phase: float = 0.0, dtype=torch.float64):
    """(frames, 4, 4) camera-to-world transforms of the periodic path
    (world: z up; camera: z forward, y down). The ellipse's size is scaled
    so that the mean translational speed is ``speed_m_per_s`` and the
    wobbles so that the mean angular speed is ``turn_deg_per_s``."""
    n = int(seq["frames"])
    rate = float(seq["rate_hz"])
    h = PATH
    phi = 2 * math.pi * torch.arange(n, dtype=dtype) / n + phase

    def poses(scale, wob):
        a, b = h["a"] * scale, h["b"] * scale
        c = torch.stack([a * torch.cos(phi), b * torch.sin(phi), h["h"] + h["dz"] * torch.sin(2 * phi)], -1)
        target = torch.stack([0.25 * torch.cos(2 * phi), 0.2 * torch.sin(3 * phi), torch.full_like(phi, 0.9)], -1)
        f = target - c
        f = f / f.norm(dim=-1, keepdim=True)
        up = torch.tensor([0.0, 0.0, 1.0], dtype=dtype).expand_as(f)
        x = torch.linalg.cross(f, up)
        x = x / x.norm(dim=-1, keepdim=True)
        y = torch.linalg.cross(f, x)
        R = torch.stack([x, y, f], -1)  # columns: camera axes in the world
        yaw = wob * h["yaw"][0] * torch.sin(h["yaw"][1] * phi)
        pitch = wob * h["pitch"][0] * torch.sin(h["pitch"][1] * phi + 1.0)
        roll = wob * h["roll"][0] * torch.sin(h["roll"][1] * phi + 2.0)
        R = R @ _rot(1, yaw) @ _rot(0, pitch) @ _rot(2, roll)
        T = torch.eye(4, dtype=dtype).repeat(n, 1, 1)
        T[:, :3, :3] = R
        T[:, :3, 3] = c
        return T

    # scale the ellipse to the mean speed, then the wobbles to the mean turn rate
    speed = _mean_speed(poses(1.0, 1.0), rate)[0]
    scale = float(seq["speed_m_per_s"]) / speed
    lo, hi = 0.0, 4.0
    for _ in range(40):  # the turn rate grows with the wobbles' amplitude
        mid = 0.5 * (lo + hi)
        if math.degrees(_mean_speed(poses(scale, mid), rate)[1]) < float(seq["turn_deg_per_s"]):
            lo = mid
        else:
            hi = mid
    return poses(scale, 0.5 * (lo + hi))


def _rot(axis, angle):
    c, s = torch.cos(angle), torch.sin(angle)
    o, z = torch.ones_like(c), torch.zeros_like(c)
    if axis == 0:
        rows = [(o, z, z), (z, c, -s), (z, s, c)]
    elif axis == 1:
        rows = [(c, z, s), (z, o, z), (-s, z, c)]
    else:
        rows = [(c, -s, z), (s, c, z), (z, z, o)]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def _mean_speed(T, rate):
    """(m/s, rad/s): mean translational and angular speed between
    consecutive frames, the last frame to the first included."""
    nxt = torch.roll(T, -1, 0)
    dt = (nxt[:, :3, 3] - T[:, :3, 3]).norm(dim=-1)
    rel = T[:, :3, :3].transpose(-1, -2) @ nxt[:, :3, :3]
    cos = ((rel.diagonal(dim1=-2, dim2=-1).sum(-1) - 1) / 2).clamp(-1, 1)
    return float(dt.mean()) * rate, float(torch.arccos(cos).mean()) * rate


def boxes(seed: int):
    """(N_BOXES, 2, 3) min/max corners: a cluster at the room's centre,
    inside the path, and the rest along the walls, outside it."""
    rng = np.random.default_rng([seed, 1])
    out = []
    for k in range(N_BOXES):
        size = rng.uniform([0.2, 0.2, 0.25], [0.6, 0.6, 1.0])
        if k < 4:  # the centre, under the camera's usual line of sight
            c = rng.uniform([-0.45, -0.3], [0.45, 0.3])
        else:  # against a wall, clear of the path
            side = rng.integers(4)
            gap = rng.uniform(0.0, 0.2)
            size[2] = rng.uniform(0.4, 2.0)
            if side < 2:
                c = [(1 - 2 * side) * (ROOM[0] - size[0] / 2 - gap), rng.uniform(-0.8, 0.8) * ROOM[1]]
            else:
                c = [rng.uniform(-0.8, 0.8) * ROOM[0], (5 - 2 * side) * (ROOM[1] - size[1] / 2 - gap)]
        lo = [c[0] - size[0] / 2, c[1] - size[1] / 2, 0.0 if k % 3 else rng.uniform(0.0, 0.5)]
        hi = [c[0] + size[0] / 2, c[1] + size[1] / 2, lo[2] + size[2]]
        out.append([lo, hi])
    return np.clip(np.asarray(out), [-ROOM[0], -ROOM[1], 0.0], [ROOM[0], ROOM[1], ROOM[2]])


def ray_depth(T_wc, cam, box_lohi, chunk: int = 64):
    """Noise-free depth (z along the optical axis, meters) of every pixel
    of every pose in `T_wc` (K, 4, 4): the nearest of the room's walls,
    floor, ceiling and the boxes. Rays are cast in float32 on T_wc's
    device; the ray's parameter is the depth itself (the ray's z is 1)."""
    dev = T_wc.device
    H, W = int(cam["rows"]), int(cam["cols"])
    v = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    u = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    d_cam = torch.stack([((u - cam["cx"]) / cam["fx"]).expand(H, W), ((v - cam["cy"]) / cam["fy"]).expand(H, W),
                         torch.ones(H, W, device=dev)], -1).reshape(-1, 3)
    lo_room = torch.tensor([-ROOM[0], -ROOM[1], 0.0], device=dev)
    hi_room = torch.tensor([ROOM[0], ROOM[1], ROOM[2]], device=dev)
    bx = torch.as_tensor(box_lohi, dtype=torch.float32, device=dev)
    out = []
    for k0 in range(0, T_wc.shape[0], chunk):
        T = T_wc[k0:k0 + chunk].to(torch.float32)
        o = T[:, None, :3, 3]  # (k, 1, 3)
        d = d_cam[None] @ T[:, :3, :3].transpose(-1, -2)  # (k, HW, 3)
        d = torch.where(d.abs() < 1e-9, torch.full_like(d, 1e-9), d)
        inv = 1.0 / d
        t_room = torch.maximum((lo_room - o) * inv, (hi_room - o) * inv).amin(-1)
        t = t_room
        for lo, hi in bx:
            t1, t2 = (lo - o) * inv, (hi - o) * inv
            near = torch.minimum(t1, t2).amax(-1)
            far = torch.maximum(t1, t2).amin(-1)
            hit = (near <= far) & (near > 0)
            t = torch.where(hit, torch.minimum(t, near), t)
        out.append(t.reshape(-1, H, W))
    return torch.cat(out)


def render_counts(seq, cam, seed: int, device):
    """The whole sequence as raw Kinect counts, (frames, H, W) on `device`
    (values 0-65535, held as int32: torch's uint16 has few operations),
    and its (frames, 4, 4) float64 camera path on the host.

    Noise and dropouts are drawn from a torch.Generator on `device` seeded
    with `seed`, in one call each; a count is round(z * counts_per_m)."""
    T = camera_path(seq)
    z = ray_depth(T.to(device), cam, boxes(int(seq["scene_seed"])))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2**63))
    noise = torch.randn(z.shape, generator=gen, device=device, dtype=torch.float32)
    drop = torch.rand(z.shape, generator=gen, device=device, dtype=torch.float32) < float(seq["dropout_share"])
    z = z + float(seq["axial_noise_m_per_m2"]) * z * z * noise
    counts = torch.round(z * float(cam["depth_counts_per_m"])).clamp(0, 65535)
    counts = torch.where(drop, torch.zeros_like(counts), counts)
    return counts.to(torch.int32), T
