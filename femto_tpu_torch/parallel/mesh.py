"""The device mesh of the sharded index: D shards of every row array.

The counterpart of femto_tpu/parallel/mesh.py.  A JAX Mesh runs one
shard_map body per device; the port runs each body once per process over
the shards that process holds, carried along a leading dimension Dl of
every per-shard tensor, and moves data between shards through the mesh's
collectives.  Two meshes give the same interface:

  * LocalMesh(D, device): all D shards in one process on one device
    (Dl = D), the analog of femto_tpu's virtual-device CPU mesh.
    all_to_all of [Dl, D, ...] is a transpose of the first two
    dimensions, all_gather a view of every shard's row, psum and pmax
    reductions over dimension 0, ppermute a roll.
  * DistMesh(): one shard per process of a torch.distributed group
    (Dl = 1): all_to_all_single, all_gather_into_tensor, all_reduce (SUM,
    MAX) and batch_isend_irecv, on NCCL for CUDA tensors and gloo for
    CPU ones (parallel/distributed.py starts the group).

A per-shard value is a tensor [Dl, ...]; a replicated value (the same on
every shard) is one tensor without that dimension.  Kernels launch on the
current CUDA stream, which NCCL's operations are ordered against.
"""

from __future__ import annotations

from typing import Union

import torch

from ..fmindex import resolve_device


class LocalMesh:
    """D shards held by one process on one device (femto_tpu's
    make_mesh(D) over D devices)."""

    def __init__(self, D: int, device: Union[str, torch.device] = "cuda"):
        if D < 1:
            raise ValueError("a mesh needs at least one shard")
        self.D = D
        self.Dl = D
        self.shard0 = 0
        self.device = resolve_device(device)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """x [Dl, D, ...] -> out[j, i] = what shard i sent shard j."""
        return x.transpose(0, 1).contiguous()

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """x [Dl, ...] -> [D, ...], every shard's row, replicated."""
        return x

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return x.sum(dim=0, dtype=x.dtype)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        return x.amax(dim=0)

    def ppermute(self, x: torch.Tensor, shift: int) -> torch.Tensor:
        """Shard i's row goes to shard (i + shift) mod D."""
        return torch.roll(x, shift % self.D, dims=0)

    def barrier(self) -> None:
        """One process: nothing to wait for."""


class DistMesh:
    """One shard per process of the default torch.distributed group."""

    def __init__(self, device: Union[str, torch.device] = "cuda"):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError("DistMesh needs torch.distributed initialised "
                               "(parallel.distributed.initialize)")
        self._dist = dist
        self.D = dist.get_world_size()
        self.Dl = 1
        self.shard0 = dist.get_rank()
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.empty_like(x)
        self._dist.all_to_all_single(out[0], x[0].contiguous())
        return out

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.empty((self.D,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        self._dist.all_gather_into_tensor(out, x.contiguous())
        return out

    def _reduce(self, x, op):
        out = x[0].clone()
        self._dist.all_reduce(out, op=op)
        return out

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, self._dist.ReduceOp.SUM)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, self._dist.ReduceOp.MAX)

    def ppermute(self, x: torch.Tensor, shift: int) -> torch.Tensor:
        shift %= self.D
        if shift == 0:
            return x
        dist = self._dist
        out = torch.empty_like(x)
        me = self.shard0
        ops = [dist.P2POp(dist.isend, x.contiguous(), (me + shift) % self.D),
               dist.P2POp(dist.irecv, out, (me - shift) % self.D)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out

    def barrier(self) -> None:
        """Every process of the group reaches this point first."""
        if self.device.type == "cuda":
            self._dist.barrier(device_ids=[self.device.index])
        else:
            self._dist.barrier()


def shard_ids(mesh) -> torch.Tensor:
    """int32[Dl]: the global index of each local shard."""
    return torch.arange(mesh.shard0, mesh.shard0 + mesh.Dl,
                        dtype=torch.int32, device=mesh.device)
