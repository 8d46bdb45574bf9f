"""The device mesh of the distributed solvers (counterpart of
``g2o_frontend_tpu/parallel/mesh.py``).

The JAX solvers are per-shard programs under ``shard_map`` over one mesh
axis, ``"shard"``: each holds a (1, ...) block of every sharded array and
talks to the others through ``psum``, ``ppermute``, ``all_to_all`` and
``axis_index``. Here each solver is written once against a mesh object
that keeps that leading block axis and offers the same four operations,
in two forms:

- `StackedMesh(n, device)`: all n shards in one process on one device.
  A sharded tensor leads with an axis of n, and a replicated one with an
  axis of 1, so that broadcasting mixes the two: ``psum`` sums axis 0
  (keeping it), ``ppermute`` rolls it, ``all_to_all`` swaps axes 0 and 1
  and ``index`` is ``arange(n)``. This is the counterpart of the JAX
  package's virtual CPU mesh, and the way one card runs n > 1 shards.
- `ProcessMesh`: one rank a device under ``torch.distributed`` (NCCL
  across cards, gloo on the CPU). A rank's block leads with an axis of 1;
  ``psum`` is ``all_reduce``, ``ppermute`` a send/receive pair, and
  ``all_to_all`` is ``all_to_all_single``.

The solvers' LM loops run through `utils.graphs.solve_loop` on either
form, and the mesh is a static argument of their graphs' key: two
`StackedMesh`es of one size on one device are equal, a `ProcessMesh` is
itself (a key holds its communicator). NCCL's collectives are captured in
the graphs like any kernel (a `ProcessMesh` at world size 1,
``tools/graph_probe.py --parallel``); over gloo the tensors lie on the
CPU, where the pieces run eagerly.

Replicated results have the same (1, ...) shape in both forms. `local`
takes a host array whose leading axis is the shard and returns the rows
this program holds; `gather` goes the other way; `flat_index` turns the
shards' row indices into rows of their blocks flattened into one, which
is how the solvers run all S local graphs as one batch.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

EDGE_AXIS = "shard"


class _Mesh:
    size: int  # D, the shards of the mesh
    shards: int  # S, the shards this program holds
    device: torch.device

    def flat_index(self, idx: torch.Tensor, n: int) -> torch.Tensor:
        """(S, ...) int64 row indices into each shard's n rows -> one vector
        of rows of the flattened (S * n, ...) block: shard s's are offset by
        s * n."""
        offsets = torch.arange(self.shards, device=self.device) * n
        return (idx + offsets.view((-1,) + (1,) * (idx.ndim - 1))).reshape(-1)

    def local(self, x, dtype=None) -> torch.Tensor:
        """A (D, ...) array or tensor -> this program's rows of it on the
        mesh's device."""
        x = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
        return self._rows(x).to(device=self.device, dtype=dtype)


class StackedMesh(_Mesh):
    """All `n` shards in one process: sharded tensors lead with an axis of n."""

    def __init__(self, n: int, device="cuda"):
        if n < 1:
            raise ValueError(f"a mesh needs at least one shard, got {n}")
        self.size = self.shards = n
        self.device = torch.device(device)

    # a static argument of the solvers' graphs (`utils.graphs`): two meshes of
    # one size on one device run the same program
    def __eq__(self, other):
        return type(other) is StackedMesh and (other.size, other.device) == (self.size, self.device)

    def __hash__(self):
        return hash((StackedMesh, self.size, self.device))

    def _rows(self, x):
        return x

    def index(self) -> torch.Tensor:
        return torch.arange(self.size, device=self.device)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return x.sum(0, keepdim=True)

    def ppermute(self, x: torch.Tensor, shift: int) -> torch.Tensor:
        """Shard t's block goes to shard (t + shift) % n."""
        return torch.roll(x, shift % self.size, 0)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """(n, n, ...): lane [t, u] is what t sends to u; returns lane [u, t]
        on u, what u received from t."""
        return x.transpose(0, 1)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return x


class ProcessMesh(_Mesh):
    """One rank of an initialised ``torch.distributed`` group: its blocks
    lead with an axis of 1. NCCL puts one rank on each card; gloo runs
    ranks on the CPU."""

    def __init__(self, device="cuda"):
        if not dist.is_initialized():
            raise RuntimeError("ProcessMesh needs an initialised torch.distributed process group")
        self.size, self.rank, self.shards = dist.get_world_size(), dist.get_rank(), 1
        self.device = torch.device(device)

    def _rows(self, x):
        return x[self.rank:self.rank + 1]

    def index(self) -> torch.Tensor:
        # filled on the device: a tensor made from a host list is a host copy, which a CUDA graph capture refuses
        return torch.full((1,), self.rank, dtype=torch.int64, device=self.device)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        y = x.sum(0, keepdim=True)
        dist.all_reduce(y)
        return y

    def ppermute(self, x: torch.Tensor, shift: int) -> torch.Tensor:
        k = shift % self.size
        if k == 0:
            return x
        x = x.contiguous()
        out = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x, (self.rank + k) % self.size),
               dist.P2POp(dist.irecv, out, (self.rank - k) % self.size)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        inp = x[0].contiguous()
        out = torch.empty_like(inp)
        dist.all_to_all_single(out, inp)
        return out[None]

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x.contiguous())
        return torch.cat(parts)


def make_mesh(n_devices: int | None = None, device="cuda"):
    """The mesh of this program: a `ProcessMesh` when ``torch.distributed``
    is initialised (its world size must be `n_devices` where that is
    given), else a `StackedMesh` of `n_devices` shards (one by default) on
    `device`."""
    if dist.is_available() and dist.is_initialized():
        mesh = ProcessMesh(device)
        if n_devices is not None and n_devices != mesh.size:
            raise ValueError(f"asked for {n_devices} devices in a process group of {mesh.size}")
        return mesh
    return StackedMesh(1 if n_devices is None else n_devices, device)


def pad_to_multiple(x: torch.Tensor, multiple: int, axis: int = 0, fill=0) -> torch.Tensor:
    """Pad a tensor with `fill` so that ``shape[axis] % multiple == 0``."""
    rem = (-x.shape[axis]) % multiple
    if rem == 0:
        return x
    shape = list(x.shape)
    shape[axis] = rem
    return torch.cat([x, x.new_full(shape, fill)], axis)


def shard_rows(x, mesh):
    """A per-edge tensor padded with zeros (masked rows) to a multiple of
    the mesh and split into its contiguous blocks: this program's (S, E/D,
    ...) rows on the mesh's device."""
    x = pad_to_multiple(x, mesh.size)
    return mesh.local(x.reshape((mesh.size, -1) + x.shape[1:]))


def tile(x, S):
    """(N, ...) replicated -> (S * N, ...): one copy a shard."""
    return x.repeat((S,) + (1,) * (x.ndim - 1)) if S > 1 else x


def offset_pairs(ij, *sizes, mesh):
    """(S, E, 2) local endpoint pairs -> (S * E, 2) indices into the S-fold
    tiled state: column c is offset by s * sizes[c]."""
    return torch.stack([mesh.flat_index(ij[..., c], n) for c, n in enumerate(sizes)], -1)
