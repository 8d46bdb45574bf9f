"""O(boundary) ghost halo exchange for block-partitioned pose graphs
(counterpart of ``g2o_frontend_tpu/parallel/halo.py``).

Each shard owns a block of poses and reads a few remote ones, its ghosts
(loop closures, block-boundary odometry). Instead of gathering the whole
pose field, a static schedule moves only the boundary blocks the ghost
directory names, and the reverse exchange scatter-adds the ghosts'
Hessian and gradient contributions back into their owners:

  ghost g of shard s owned by shard t  ->  ring shift k = (s - t) mod D.

For each active shift every owner packs the blocks its (t+k)-th neighbour
needs into a dense buffer (padded to the most over owners) and one
``ppermute`` moves them all; or, in the "a2a" mode, one ``all_to_all``
moves every partner's lane at once. Bytes per device and direction are
O(ghosts), independent of N.

The schedule (`HaloSpec`, `build_halo_spec`) is the JAX package's host
code, copied. The exchanges run on a mesh (`parallel/mesh.py`): blocks
lead with the shard axis S of the program (n on a `StackedMesh`, 1 on a
`ProcessMesh`), and so do the schedule's rows.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class HaloSpec(NamedTuple):
    """Static exchange schedule. Arrays lead with the device axis D so they
    shard with the rest of the problem; everything else is static python
    metadata baked into the compiled program.

    Two wire modes, chosen at build time from the schedule's shape:
      "ppermute": one point-to-point round per active ring shift — minimal
        bytes (sum_k S_k), best when ghosts touch few neighbor blocks
        (odometry chains: a single shift).
      "a2a": ONE fused ``all_to_all`` per direction regardless of partner
        count — collective count stays constant as the partner set grows
        (loop-closure-rich graphs), at the cost of padding every partner
        lane to the max pairwise count.
    """

    mode: str  # "ppermute" | "a2a"
    shifts: tuple  # ppermute: (K,) active ring shifts, each in [1, D)
    sizes: tuple  # ppermute: per-shift max slot count over devices
    pair_size: int  # a2a: max slots exchanged by any (src, dst) pair
    send_idx: np.ndarray  # ppermute (D, K, Smax) / a2a (D, D, S); pad 0
    recv_pos: np.ndarray  # same shape; ghost slots to fill, pad G = dropped
    n_ghost: int  # G: ghost-slot capacity per device
    n_dev: int


def build_halo_spec(ghosts: list, B: int, n_dev: int, G: int,
                    mode: str = "auto", owner=None, local=None) -> HaloSpec:
    """Build the schedule from per-shard sorted ghost-id lists.

    Args:
      ghosts: ghosts[s] = sorted global ids shard s reads but does not own
        (the ghost directory; ghost slot r on s holds ghosts[s][r]).
      B: block size (owner of id p is p // B) — ignored when owner/local
        lookup arrays are given (arbitrary ownership, e.g. landmarks
        assigned to the pose block that observes them most).
      G: padded ghost capacity per device (recv positions use G as "drop").
      mode: "ppermute", "a2a", or "auto" (ppermute while the active-shift
        count stays small, a2a beyond that).
      owner/local: optional arrays mapping global id -> owning device /
        owner-local slot.
    """
    if owner is None:
        owner = lambda gid: gid // B  # noqa: E731
        local = lambda gid: gid % B  # noqa: E731
    else:
        _own, _loc = owner, local
        owner = lambda gid: int(_own[gid])  # noqa: E731
        local = lambda gid: int(_loc[gid])  # noqa: E731
    # (shift k) -> (sender t) -> ordered [(t-local idx, ghost slot on s)]
    by_shift: dict = {}
    for s in range(n_dev):
        for pos, gid in enumerate(ghosts[s]):
            t = owner(gid)
            assert t != s, (s, gid)
            k = (s - t) % n_dev
            by_shift.setdefault(k, {}).setdefault(t, []).append(
                (local(gid), pos)
            )
    shifts = tuple(sorted(by_shift))
    sizes = tuple(
        max(len(v) for v in by_shift[k].values()) for k in shifts
    )
    if mode == "auto":
        # a2a cuts the collective count to 1 regardless of partner count,
        # at the cost of padding every partner lane to the max pairwise
        # count. The JAX package's rule, kept so that both packages pick
        # the same wire mode (its measurement, scripts/bench_halo_modes.py,
        # was taken on another machine and is no figure of this port):
        # a2a whenever >2 shifts are active, unless its lane padding would
        # more than double the bytes.
        pair = max(
            (len(e) for k in by_shift for e in by_shift[k].values()),
            default=1,
        )
        a2a_slots = (n_dev - 1) * pair
        mode = (
            "a2a"
            if len(shifts) > 2 and a2a_slots <= 2.0 * sum(sizes)
            else "ppermute"
        )

    if mode == "ppermute":
        Smax = max(sizes, default=1)
        K = max(len(shifts), 1)
        send_idx = np.zeros((n_dev, K, Smax), np.int32)
        recv_pos = np.full((n_dev, K, Smax), G, np.int32)
        for i, k in enumerate(shifts):
            for t, entries in by_shift[k].items():
                s = (t + k) % n_dev
                for j, (loc, pos) in enumerate(entries):
                    send_idx[t, i, j] = loc
                    recv_pos[s, i, j] = pos
        return HaloSpec(mode, shifts, sizes, 0, send_idx, recv_pos, G, n_dev)

    # a2a: lane [t, u] on device t holds what t sends to u
    S = 1
    for k in by_shift:
        for entries in by_shift[k].values():
            S = max(S, len(entries))
    send_idx = np.zeros((n_dev, n_dev, S), np.int32)
    recv_pos = np.full((n_dev, n_dev, S), G, np.int32)
    for k in shifts:
        for t, entries in by_shift[k].items():
            s = (t + k) % n_dev
            for j, (loc, pos) in enumerate(entries):
                send_idx[t, s, j] = loc
                recv_pos[s, t, j] = pos
    return HaloSpec(mode, shifts, sizes, S, send_idx, recv_pos, G, n_dev)


def halo_bytes_per_exchange(spec: HaloSpec, d: int, itemsize: int = 4) -> int:
    """Worst-case per-device bytes sent for ONE direction of the exchange."""
    if spec.mode == "a2a":
        # the self-lane [t, t] never leaves the device
        return int((spec.n_dev - 1) * spec.pair_size * d * itemsize)
    return int(sum(spec.sizes) * d * itemsize)


def halo_collectives_per_exchange(spec: HaloSpec) -> int:
    """Collective launches for ONE direction of the exchange."""
    if spec.mode == "a2a":
        return 1 if spec.n_dev > 1 else 0
    return len(spec.shifts)


def _rows(x, idx, mesh):
    """``x[s, idx[s]]`` for each shard s held here: x (S, N, ...), idx (S,
    ...) int64 -> idx.shape + x.shape[2:]."""
    flat = x.reshape((-1,) + x.shape[2:]).index_select(0, mesh.flat_index(idx, x.shape[1]))
    return flat.reshape(idx.shape + x.shape[2:])


def halo_gather(v_blk, send_idx, recv_pos, spec: HaloSpec, mesh):
    """(S, B, ...) own blocks -> (S, G, ...) ghost values.

    send_idx and recv_pos are this program's rows of the schedule's
    arrays, int64 on the mesh's device. Unfilled ghost slots (padding
    beyond a shard's true ghost count) come back zero; edges referencing
    them are masked out upstream.
    """
    S, G, tail = v_blk.shape[0], spec.n_ghost, v_blk.shape[2:]
    out = v_blk.new_zeros((S * (G + 1),) + tail)
    if spec.mode == "a2a":
        if spec.n_dev > 1:
            rec = mesh.all_to_all(_rows(v_blk, send_idx, mesh))  # (S, D, S_pair, ...)
            out.index_copy_(0, mesh.flat_index(recv_pos, G + 1), rec.reshape((-1,) + tail))
        return out.view((S, G + 1) + tail)[:, :G]
    for i, k in enumerate(spec.shifts):
        n = spec.sizes[i]
        rec = mesh.ppermute(_rows(v_blk, send_idx[:, i, :n], mesh), k)
        out.index_copy_(0, mesh.flat_index(recv_pos[:, i, :n], G + 1), rec.reshape((-1,) + tail))
    return out.view((S, G + 1) + tail)[:, :G]


def halo_reduce(own, ghost_contrib, send_idx, recv_pos, spec: HaloSpec, mesh):
    """Reverse exchange: (S, G, ...) ghost contributions -> scatter-added
    into their owners' (S, B, ...) blocks. Returns the updated own blocks
    (`own` itself is not modified). Ghosts of one owner read by several
    shards all add into it (``index_add``)."""
    S, B, tail = own.shape[0], own.shape[1], own.shape[2:]
    ext = torch.cat([ghost_contrib, ghost_contrib.new_zeros((S, 1) + tail)], 1)
    flat = own.reshape((S * B,) + tail)
    if spec.mode == "a2a":
        if spec.n_dev > 1:
            rec = mesh.all_to_all(_rows(ext, recv_pos, mesh))  # padded slots pick the zero row
            flat = flat.index_add(0, mesh.flat_index(send_idx, B), rec.reshape((-1,) + tail))
        return flat.view(own.shape)
    for i, k in enumerate(spec.shifts):
        n = spec.sizes[i]
        rec = mesh.ppermute(_rows(ext, recv_pos[:, i, :n], mesh), -k)
        flat = flat.index_add(0, mesh.flat_index(send_idx[:, i, :n], B), rec.reshape((-1,) + tail))
    return flat.view(own.shape)
