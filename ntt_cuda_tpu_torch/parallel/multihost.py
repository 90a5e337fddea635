"""Multi-process runtime setup for the sharded programs.

Counterpart of `ntt_cuda_tpu/parallel/multihost.py` (which starts the JAX
multi-controller runtime) on torch.distributed: one process per card,
NCCL between cards, and an ('rns', 'coef') mesh laid over the processes
so that the coefficient axis, whose transforms exchange data at every
stage, stays within a host, while the RNS axis, which carries only the
modulus-axis all-reduces, spans hosts.  Nothing here reads a cluster's
environment beyond torch's own variables: the caller passes the address,
the world size and the rank.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from . import mesh as mesh_mod


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               backend: str | None = None) -> None:
    """Start the default process group.  Call once per process, before
    any mesh or context is built.

    coordinator_address: "host:port" (tcp) or an init_method URL
    ("tcp://...", "file://..."); None reads torch's env:// variables.
    backend None is NCCL, one card per process: the process's card
    (LOCAL_RANK, else the process id, modulo the card count) is made
    current first, as NCCL needs.  Pass backend="gloo" for CPU processes
    (gloo also takes CUDA tensors, several processes to one card)."""
    backend = backend or "nccl"
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("multihost.initialize: the NCCL backend needs "
                               "a CUDA card; pass backend='gloo' for CPU "
                               "processes")
        local = int(os.environ.get("LOCAL_RANK", process_id or 0))
        torch.cuda.set_device(local % torch.cuda.device_count())
    init_method = coordinator_address
    if init_method is not None and "://" not in init_method:
        init_method = f"tcp://{init_method}"
    dist.init_process_group(
        backend, init_method=init_method,
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id)


def _local_processes(device_type: str) -> int:
    """Processes on this host: LOCAL_WORLD_SIZE where a launcher sets it,
    else one per card (CUDA) or this one alone (CPU)."""
    if "LOCAL_WORLD_SIZE" in os.environ:
        return int(os.environ["LOCAL_WORLD_SIZE"])
    return torch.cuda.device_count() if device_type == "cuda" else 1


def pod_mesh(rns: int | None = None, coef: int | None = None,
             device_type=None):
    """An ('rns', 'coef') mesh over every rank of the default group.

    The defaults put the coef axis within a host and the rns axis across
    hosts: ranks are numbered host-major, so rows of `coef` consecutive
    ranks stay on one host while coef is at most the host's process
    count."""
    device_type = mesh_mod._device_type(device_type)
    total = dist.get_world_size()
    if coef is None:
        coef = min(_local_processes(device_type), total)
    if rns is None:
        rns = total // coef
    if rns * coef != total:
        raise ValueError(f"rns*coef = {rns}*{coef} != {total} ranks")
    return mesh_mod.make_mesh(rns, coef, device_type)


def is_coordinator() -> bool:
    return dist.get_rank() == 0
