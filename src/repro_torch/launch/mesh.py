"""The ``(data, model)`` process groups for the launcher (port of
``repro.launch.mesh``).

The reference builds a ``("data", "model")`` device mesh; the port runs
one rank per mesh position, set up here from what ``torchrun`` puts in
the environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``).  Rank ``r = data_index * model +
model_index`` -- the reference mesh's row-major order -- so a model group
is ``model`` consecutive ranks and a data group every ``model``-th rank.
With ``model == 1`` the data group is the default (world) group, named
``"data"``.  Without ``torchrun`` a one-rank
group is made on an in-process store, so ``--data 1`` needs no address
at all.  NCCL on ``cuda``, gloo on ``cpu``.  Nothing happens at import.
"""

from __future__ import annotations

import os
from typing import Any, NamedTuple

import torch
import torch.distributed as dist


class Mesh(NamedTuple):
    device: torch.device   # this rank's device (cuda:LOCAL_RANK on a GPU)
    created: bool          # this call made the default group
    data_index: int        # position on the data axis
    model_index: int       # position on the model axis (the slab index)
    data_group: Any        # this rank's data group ("data": the world)
    model_group: Any       # this rank's model group (None when model == 1)
    data_size: int = 1     # ranks on the data axis
    model_size: int = 1    # ranks on the model axis (sharding.rules reads
                           # both as the mesh's shape)


def init_mesh(data: int, model: int, device) -> Mesh:
    """Join (or create) the default group of ``data * model`` ranks and
    build the model and data groups.  Raises when ``data * model`` is not
    the world size (the initialized group's, or the one ``torchrun``
    gives).  The caller destroys what this made with
    :func:`destroy_mesh`."""
    device = torch.device(device)
    if data < 1 or model < 1:
        raise ValueError(f"--data {data} --model {model}: both must be >= 1")
    n = data * model
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", "1")))
    if world != n:
        raise ValueError(
            f"--data {data} x --model {model} must equal the world size "
            f"{world}: launch with torchrun --nproc-per-node {n}")
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    created = False
    if not dist.is_initialized():
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
        created = True
    return _mesh_groups(data, model, device, created)


def _mesh_groups(data: int, model: int, device, created: bool) -> Mesh:
    """This rank's :class:`Mesh` on the initialized default group."""
    n = data * model
    d_idx, m_idx = divmod(dist.get_rank(), model)
    if model == 1:
        return Mesh(device, created, d_idx, m_idx, "data", None, data, model)
    # every rank creates every group, in the same order
    model_groups = [dist.new_group(list(range(d * model, (d + 1) * model)))
                    for d in range(data)]
    data_groups = [dist.new_group(list(range(m, n, model)))
                   for m in range(model)]
    return Mesh(device, created, d_idx, m_idx, data_groups[m_idx],
                model_groups[d_idx], data, model)


FAKE_BACKEND = "fake"


def _register_fake_backend() -> None:
    """The ``"fake"`` process-group backend: torch's ``FakeProcessGroup``,
    whose collectives return at once and move nothing (as PyTorch's own
    testing helper registers it)."""
    from torch._C._distributed_c10d import FakeProcessGroup

    if FAKE_BACKEND.upper() in dist.Backend._plugins:
        return

    def create(common_opts, backend_opts):
        return FakeProcessGroup._create_internal(
            common_opts.group_rank, common_opts.group_size, backend_opts)

    dist.Backend.register_backend(FAKE_BACKEND, create, extended_api=True,
                                  devices=["cpu", "cuda"])


def init_fake_mesh(data: int, model: int, rank: int = 0,
                   device="meta") -> Mesh:
    """Join a fake default group of ``data * model`` ranks as ``rank`` and
    build the same ``(data, model)`` groups as :func:`init_mesh`: the dry
    run's world (:mod:`repro_torch.launch.dryrun`), one rank's step traced
    with every other rank imagined.  No collective moves data, no device
    is selected and no peer is needed.  The caller destroys it with
    :func:`destroy_mesh`."""
    if data < 1 or model < 1:
        raise ValueError(f"--data {data} --model {model}: both must be >= 1")
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized; the "
                           "fake world must be the default group")
    n = data * model
    if not 0 <= rank < n:
        raise ValueError(f"rank {rank} outside a world of {n}")
    _register_fake_backend()
    dist.init_process_group(FAKE_BACKEND, store=dist.HashStore(), rank=rank,
                            world_size=n)
    return _mesh_groups(data, model, torch.device(device), True)


def destroy_mesh(mesh: Mesh) -> None:
    """Destroy the default group (and with it the mesh's groups) if
    ``mesh`` made it."""
    if mesh.created and dist.is_initialized():
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
