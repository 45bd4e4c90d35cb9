"""Process-group start-up and the job-wide mesh: the counterpart of the
JAX package's `parallel/distributed.py`.

Under `torchrun` every process calls `initialize()` once, before any
collective; then `make_pod_mesh()` builds the (data, model) mesh over
every rank. One rank drives one card:

    torchrun --nproc_per_node 4 -m accelerated_features_tpu_torch.train.run \\
        --ckpt_save_path CKPT --dry_run --mesh 2x2

A single process without `torchrun` starts no group, and the same code
runs on its one device.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from .mesh import Mesh, make_mesh, world


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device: str = "cuda",
               backend: Optional[str] = None) -> bool:
    """`init_process_group` for this process; True when a group exists.

    Unset arguments come from `torchrun`'s environment (`MASTER_ADDR` and
    `MASTER_PORT`, `WORLD_SIZE`, `RANK`, `LOCAL_RANK`). Without a
    coordinator address and with one process, nothing is started. The
    backend is NCCL for `device="cuda"` and gloo for `"cpu"` (`backend`
    overrides it: gloo also runs CUDA tensors, through the host). On cuda
    the process takes card `LOCAL_RANK` (else `process_id`) modulo the
    cards it sees; there is no card, it raises."""
    env = os.environ
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(env.get("RANK", "0"))
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if coordinator_address is None and num_processes <= 1:
        return False
    if coordinator_address is None:
        raise ValueError(f"{num_processes} processes need a coordinator "
                         f"address (host:port, or torchrun's MASTER_ADDR)")
    if dist.is_initialized():
        return True
    if device.startswith("cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError("initialize(device='cuda') found no CUDA "
                               "device; pass device='cpu' for gloo on the "
                               "CPU")
        local = int(env.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(local % torch.cuda.device_count())
    backend = backend or ("nccl" if device.startswith("cuda") else "gloo")
    dist.init_process_group(backend, init_method=f"tcp://"
                            f"{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return True


def make_pod_mesh(model: int = 1) -> Mesh:
    """(world/model, model) mesh over every rank of the job."""
    n = world()[1]
    if n % model:
        raise ValueError(f"{n} ranks do not divide by model={model}")
    return make_mesh((n // model, model))


def is_primary() -> bool:
    """True on the rank that writes checkpoints and logs (rank 0)."""
    return world()[0] == 0


def shutdown() -> None:
    """Destroy the default group, if one was started."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


__all__ = ["initialize", "make_pod_mesh", "is_primary", "shutdown"]
