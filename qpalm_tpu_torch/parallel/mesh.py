"""The port's stand-in for a one-axis `jax.sharding.Mesh` and the
collectives that `shard_map` code calls on it (`ppermute`, `all_gather`,
`psum`, `pmax`, `axis_index`).

Code in this package is written once against the mesh object and runs
on either implementation:

* `LocalMesh(nd, device)`: all nd shards on one device, as the leading
  dimension of every shard-local tensor.  A shift is a roll along that
  dimension, a gather is the identity, a sum or max reduces along it.
  This is how one card runs a mesh; on a GPU it is also the point of
  SPIKE, since nd chunks of a block-Thomas sweep run as one batch of
  kernel launches, S / nd deep instead of S deep.
* `DistMesh(group)`: one shard a process over `torch.distributed`,
  leading dimension 1: gloo on the CPU, NCCL on cards (`cuda:local_rank`).
  A shift goes through `batch_isend_irecv`; a shift to oneself is a copy.

One summation order: every `psum` gathers the shards' partial values and
adds them in shard order (`sum` over the gathered dimension), so that both
meshes, at any number of shards, add in one order, and a k-process run is
bit for bit the same as `LocalMesh(k)`.  The payloads are a few scalars or
nb x nb blocks, so the gather costs nothing.

Shard-local tensors have shape (L, ...) with L = `mesh.local` (nd for a
LocalMesh, 1 for a DistMesh); `mesh.index` holds the shard index of each
of the L rows.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["LocalMesh", "DistMesh", "default_mesh"]


class LocalMesh:
    """nd shards on one device, the leading dimension of every shard-local
    tensor."""

    def __init__(self, nd: int, device="cuda"):
        if nd < 1:
            raise ValueError(f"LocalMesh: nd = {nd} < 1")
        self.size = int(nd)
        self.local = self.size
        self.device = torch.device(device)
        self.index = torch.arange(self.size, device=self.device)

    def __repr__(self):
        return f"LocalMesh({self.size}, device={str(self.device)!r})"

    def ppermute(self, v: torch.Tensor, shift: int) -> torch.Tensor:
        """Row i receives the row of shard i - shift (mod size)."""
        return torch.roll(v, shift, 0)

    def all_gather(self, v: torch.Tensor) -> torch.Tensor:
        """(L, ...) -> (size, ...): every shard's row, in shard order."""
        return v

    def shard(self, t: torch.Tensor) -> torch.Tensor:
        """A global (S, ...) tensor, stage-major, -> (L, S / size, ...)."""
        return t.reshape((self.size, t.shape[0] // self.size)
                         + tuple(t.shape[1:]))

    def unshard(self, t: torch.Tensor) -> torch.Tensor:
        """(L, S_loc, ...) -> the global (S, ...) view (LocalMesh) or the
        shard's own (S_loc, ...) (DistMesh)."""
        return t.reshape((-1,) + tuple(t.shape[2:]))

    def psum(self, v: torch.Tensor) -> torch.Tensor:
        """Per-shard partials (L, ...) -> their sum in shard order, on
        every row."""
        g = self.all_gather(v)
        return g.sum(0, keepdim=True).expand((self.local,)
                                             + tuple(g.shape[1:]))

    def pmax(self, v: torch.Tensor) -> torch.Tensor:
        g = self.all_gather(v)
        return g.amax(0, keepdim=True).expand((self.local,)
                                              + tuple(g.shape[1:]))


class DistMesh(LocalMesh):
    """One shard a process of a `torch.distributed` group (gloo or NCCL);
    shard-local tensors have a leading dimension of 1."""

    def __init__(self, group=None, device=None):
        if not dist.is_initialized():
            raise RuntimeError("DistMesh: torch.distributed is not "
                               "initialised (init_process_group)")
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.local = 1
        if device is None:
            device = "cuda" if dist.get_backend(group) == "nccl" else "cpu"
            if device == "cuda":
                device = torch.device("cuda", torch.cuda.current_device())
        self.device = torch.device(device)
        self.index = torch.full((1,), self.rank, dtype=torch.int64,
                                device=self.device)

    def __repr__(self):
        return (f"DistMesh(rank {self.rank} of {self.size}, "
                f"{dist.get_backend(self.group)}, {self.device})")

    def _peer(self, r: int) -> int:
        return r if self.group is None else \
            dist.get_global_rank(self.group, r)

    def ppermute(self, v: torch.Tensor, shift: int) -> torch.Tensor:
        if shift % self.size == 0:
            return v.clone()
        v = v.contiguous()
        out = torch.empty_like(v)
        dst = self._peer((self.rank + shift) % self.size)
        src = self._peer((self.rank - shift) % self.size)
        ops = [dist.P2POp(dist.isend, v, dst, self.group),
               dist.P2POp(dist.irecv, out, src, self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out

    def all_gather(self, v: torch.Tensor) -> torch.Tensor:
        v = v.contiguous()
        parts = [torch.empty_like(v) for _ in range(self.size)]
        dist.all_gather(parts, v, group=self.group)
        return torch.cat(parts, 0)

    def shard(self, t: torch.Tensor) -> torch.Tensor:
        s = t.shape[0] // self.size
        return t[self.rank * s:(self.rank + 1) * s][None]


def default_mesh(n_devices=None, device="cuda"):
    """A `DistMesh` over the world when a process group is initialised,
    else `LocalMesh(n_devices or 1)` on `device` (qpalm_tpu/parallel/
    sharded.py:27, where the mesh spans the process's devices; a mesh
    here has one unnamed axis)."""
    if dist.is_available() and dist.is_initialized():
        mesh = DistMesh()
        if n_devices is not None and n_devices != mesh.size:
            raise ValueError(f"default_mesh({n_devices}): the process group "
                             f"has {mesh.size} ranks")
        return mesh
    return LocalMesh(n_devices or 1, device=device)
