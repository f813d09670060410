"""Multi-process entry points: torch.distributed + the global mesh.

The counterpart of femto_tpu/parallel/distributed.py.  Every process runs
the same program over a DistMesh (parallel/mesh.py): one shard per
process, the collectives on NCCL between cards (gloo for CPU tensors).
Nothing tells a process of its cluster, so the caller names it:

    from femto_tpu_torch.parallel import distributed as ftd
    ftd.initialize("localhost:29500", num_processes=2, process_id=rank)
    mesh = ftd.global_mesh()
    index = build_index_sharded(prepared, mesh)
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, cpu_collectives: Optional[str] = None) -> None:
    """Start the process group over tcp://coordinator_address: on gloo
    when cpu_collectives is "gloo" (femto_tpu's CPU runs), else NCCL."""
    import torch.distributed as dist

    backend = "gloo" if cpu_collectives == "gloo" else "nccl"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def global_mesh(device: Union[str, torch.device] = "cuda"):
    """A DistMesh over every process of the group."""
    from .mesh import DistMesh

    return DistMesh(device=device)


def put_global(arr, mesh) -> torch.Tensor:
    """A host array onto the mesh, cut into the D equal blocks of its row
    dimension: the process's own blocks, [Dl, m, ...]."""
    a = torch.from_numpy(np.ascontiguousarray(arr))
    m = a.shape[0] // mesh.D
    if m * mesh.D != a.shape[0]:
        raise ValueError("the row dimension must split into D blocks")
    a = a[mesh.shard0 * m:(mesh.shard0 + mesh.Dl) * m].reshape(
        (mesh.Dl, m) + tuple(a.shape[1:]))
    return a.to(mesh.device)
