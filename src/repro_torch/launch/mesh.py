"""Data-parallel process group for the launcher (port of
``repro.launch.mesh``).

The reference builds a ``("data", "model")`` device mesh; the port's
``"data"`` axis is the default ``torch.distributed`` process group, one
rank per worker, set up here from what ``torchrun`` puts in the
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``).  Without ``torchrun`` a one-rank group is made on an
in-process store, so ``--data 1`` needs no address at all.  NCCL on
``cuda``, gloo on ``cpu``.  Nothing happens at import.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def init_data_group(data: int, device) -> tuple[torch.device, bool]:
    """Join (or create) the ``data`` process group of ``data`` ranks.

    Returns this rank's device (``cuda:LOCAL_RANK`` on the GPU) and
    whether this call created the group (the caller then destroys it
    with :func:`destroy_data_group`).  Raises when ``data`` is not the
    world size ``torchrun`` gives."""
    device = torch.device(device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world != data:
        raise ValueError(
            f"--data {data} must equal the world size {world}: launch "
            f"with torchrun --nproc-per-node {data}")
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    if dist.is_initialized():
        if dist.get_world_size() != data:
            raise ValueError(
                f"--data {data} does not match the initialized process "
                f"group of {dist.get_world_size()} ranks")
        return device, False
    backend = "nccl" if device.type == "cuda" else "gloo"
    rank = int(os.environ.get("RANK", "0"))
    if "MASTER_ADDR" in os.environ:
        dist.init_process_group(backend, init_method="env://", rank=rank,
                                world_size=world)
    elif world == 1:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    else:
        raise ValueError("a group of several ranks needs torchrun (or "
                         "MASTER_ADDR/MASTER_PORT) to find its peers")
    return device, True


def destroy_data_group() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def shard_batch(batch: dict, rank: int, n_shards: int, axis: int = 0):
    """This rank's contiguous shard of a global batch along ``axis`` (the
    reference's ``P("data")``; ``axis=1`` under grad accumulation, where
    axis 0 is the microbatch)."""
    out = {}
    for k, v in batch.items():
        n = v.shape[axis]
        if n % n_shards:
            raise ValueError(f"batch axis of {n} does not split over "
                             f"{n_shards} ranks")
        out[k] = v.narrow(axis, rank * (n // n_shards),
                          n // n_shards).contiguous()
    return out
