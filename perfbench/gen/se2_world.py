"""Seeded 2D landmark-SLAM worlds written as `.g2o` text.

A frozen copy of the repository's graph simulator (graph_merge's
GraphSimulator: a random walk with Manhattan turns on a bounded square,
noisy odometry, loop closures within a radius, range-limited landmark
observations), numpy only, so that the benchmark's inputs do not move when
the program's simulator does. Unlike the original, the landmarks stand
beside the path, and ``n_observations`` of the observations in range are
kept, every landmark's at least twice (a dataset's count of sightings);
the structure and
the whole world, its noise included, comes from the configuration's
``world_seed``, and the run's seed only draws the vertices' ids: every
run solves the same graph, row for row, with the same sizes and the same
work (a solver's rows follow the file's order, not its ids). The file is what a user
hands the backend: VERTEX_SE2 at the odometry's integration, VERTEX_XY, FIX 0, EDGE_SE2 and
EDGE_SE2_XY with their information matrices' upper triangles.
"""
from __future__ import annotations

import io

import numpy as np

ID_RANGE = 8  # vertex ids are drawn from [0, ID_RANGE x the vertex count)


def _rel(a, b):
    c, s = np.cos(a[2]), np.sin(a[2])
    d = b[:2] - a[:2]
    return np.array([c * d[0] + s * d[1], -s * d[0] + c * d[1], (b[2] - a[2] + np.pi) % (2 * np.pi) - np.pi])


def simulate(cfg: dict):
    """(ground-truth poses (N, 3), landmarks (L, 2), odometry edges, closure
    edges, observations) of the configuration's ``world_seed``; an edge is
    (i, j, z, information)."""
    rng = np.random.default_rng(cfg["world_seed"])
    half = cfg["world_size"] / 2
    step = cfg["step"]
    poses = [np.zeros(3)]
    for _ in range(cfg["n_poses"] - 1):
        x = poses[-1].copy()
        if rng.random() < cfg["turn_prob"]:
            x[2] += rng.choice([-np.pi / 2, np.pi / 2])
        nxt = x + np.array([step * np.cos(x[2]), step * np.sin(x[2]), 0.0])
        if abs(nxt[0]) > half or abs(nxt[1]) > half:  # bounce off the world's bounds
            x[2] += np.pi / 2
            nxt = x + np.array([step * np.cos(x[2]), step * np.sin(x[2]), 0.0])
        poses.append(nxt)
    gt = np.asarray(poses)
    gt[:, 2] = (gt[:, 2] + np.pi) % (2 * np.pi) - np.pi
    pairs = []
    for j in range(len(gt)):
        if rng.random() > cfg["closure_prob"]:
            continue
        d = np.linalg.norm(gt[:j - 10, :2] - gt[j, :2], axis=1) if j > 10 else []
        if len(d) and d.min() < cfg["closure_radius"]:
            pairs.append((int(np.argmin(d)), j))
    # beside the path, each within sensing range of some pose
    at = gt[rng.choice(len(gt), cfg["n_landmarks"], replace=False), :2]
    r = 0.8 * cfg["sense_range"] * np.sqrt(rng.random(cfg["n_landmarks"]))
    a = rng.uniform(-np.pi, np.pi, cfg["n_landmarks"])
    lms = at + np.stack([r * np.cos(a), r * np.sin(a)], 1)

    noise = np.random.default_rng([cfg["world_seed"], 1])
    sig = np.asarray(cfg["odom_noise"], np.float64)
    info_o = np.diag(1.0 / sig**2)
    odom = [(i, i + 1, _rel(gt[i], gt[i + 1]) + noise.normal(0, sig, 3), info_o) for i in range(len(gt) - 1)]
    closures = [(i, j, _rel(gt[i], gt[j]) + noise.normal(0, sig, 3), info_o) for i, j in pairs]
    info_l = np.eye(2) / cfg["obs_noise"] ** 2
    seen = []
    for i, x in enumerate(gt):
        c, s = np.cos(x[2]), np.sin(x[2])
        rel = (lms - x[:2]) @ np.array([[c, s], [-s, c]]).T
        seen += [(i, int(l), rel[l]) for l in np.where(np.linalg.norm(rel, axis=1) < cfg["sense_range"])[0]]
    lm_of = np.array([l for _, l, _ in seen])
    by_lm = [np.flatnonzero(lm_of == m) for m in range(len(lms))]
    keep = np.unique(np.concatenate([rng.choice(k, 2, replace=False) for k in by_lm]))
    rest = np.setdiff1d(np.arange(len(seen)), keep)
    keep = np.sort(np.concatenate([keep, rng.choice(rest, cfg["n_observations"] - len(keep), replace=False)]))
    seen = [seen[k] for k in keep]
    obs = [(i, l, z + noise.normal(0, cfg["obs_noise"], 2), info_l) for i, l, z in seen]
    return gt, lms, odom, closures, obs


def _upper(M):
    d = M.shape[0]
    return " ".join(repr(float(M[r, c])) for r in range(d) for c in range(r, d))


def g2o_text(cfg: dict, seed: int) -> str:
    """The configuration's world as a `.g2o` file's text, poses at the
    odometry's integration (what SLAM starts from), in the simulator's
    order; `seed` draws distinct vertex ids for the poses and landmarks."""
    gt, lms, odom, closures, obs = simulate(cfg)
    ids = np.random.default_rng(seed).choice(ID_RANGE * (len(gt) + len(lms)), len(gt) + len(lms), replace=False)
    pid, lid = ids[: len(gt)], ids[len(gt):]
    init = np.zeros_like(gt)
    init[0] = gt[0]
    for i, _, z, _ in odom:
        c, s = np.cos(init[i, 2]), np.sin(init[i, 2])
        init[i + 1] = [init[i, 0] + c * z[0] - s * z[1], init[i, 1] + s * z[0] + c * z[1], init[i, 2] + z[2]]
    out = io.StringIO()
    for k, p in enumerate(init):
        out.write(f"VERTEX_SE2 {pid[k]} {float(p[0])!r} {float(p[1])!r} {float(p[2])!r}\n")
    if obs:
        for l, p in enumerate(lms):
            out.write(f"VERTEX_XY {lid[l]} {float(p[0])!r} {float(p[1])!r}\n")
    out.write(f"FIX {pid[0]}\n")
    for i, j, z, w in odom + closures:
        out.write(f"EDGE_SE2 {pid[i]} {pid[j]} {float(z[0])!r} {float(z[1])!r} {float(z[2])!r} {_upper(w)}\n")
    for i, l, z, w in obs:
        out.write(f"EDGE_SE2_XY {pid[i]} {lid[l]} {float(z[0])!r} {float(z[1])!r} {_upper(w)}\n")
    return out.getvalue()
