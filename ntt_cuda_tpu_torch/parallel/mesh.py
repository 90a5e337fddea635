"""The ('rns', 'coef') device mesh, DTensor placements, and the counted
collectives of the sharded programs.

Counterpart of `ntt_cuda_tpu/parallel/mesh.py`.  The reference's RNS
modulus batching (its grid-y axis) maps onto the 'rns' mesh axis, which is
embarrassingly parallel apart from the BEHZ reduce and the last-modulus
broadcast; the coefficient axis ('coef') is the transform's split.  A JAX
PartitionSpec becomes a DTensor placement list, one entry per mesh axis:
P('rns') on an (r, n) tensor is [Shard(0)] on a 1-D ('rns',) mesh, and on
a (2, r, n) tensor [Shard(1)].

`all_reduce` and `all_gather` are the only ways the sharded programs talk
across ranks.  Each call is logged in `collectives` as ("all_reduce",
shape) or ("all_gather", gathered shape) before it runs (clear the list to
start a count): torch has no compiled program to inspect, so this log
stands in for the JAX package's `lowered_*` HLO counts
(tests/test_collectives.py), as the kernels' `launches` counters do for
their launches.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .. import cuda

RNS_AXIS = "rns"
COEF_AXIS = "coef"


def _device_type(device_type) -> str:
    """`device_type`, where None is CUDA (raising where there is none)."""
    return cuda.default_device(device_type, "device mesh").type


def make_mesh(rns: int = 1, coef: int = 1, device_type=None):
    """An (rns, coef) DeviceMesh over the default process group's ranks,
    axes named ('rns', 'coef').  rns * coef must be the world size.
    `device_type` None is "cuda"; "cpu" for gloo processes on the CPU."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(_device_type(device_type), (rns, coef),
                            mesh_dim_names=(RNS_AXIS, COEF_AXIS))


def rns_mesh(device_type=None):
    """A 1-D ('rns',) DeviceMesh over every rank of the default group."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(_device_type(device_type),
                            (dist.get_world_size(),),
                            mesh_dim_names=(RNS_AXIS,))


def _placements(mesh, by_axis: dict) -> list:
    from torch.distributed.tensor import Replicate
    return [by_axis.get(name, Replicate()) for name in mesh.mesh_dim_names]


def residue_sharding(mesh, ndim: int = 2, shard_coef: bool = False) -> list:
    """Placements of a (..., r, n) residue tensor: the RNS axis over 'rns',
    the coefficient axis over 'coef' (or replicated)."""
    from torch.distributed.tensor import Replicate, Shard
    return _placements(mesh, {RNS_AXIS: Shard(ndim - 2),
                              COEF_AXIS: (Shard(ndim - 1) if shard_coef
                                          else Replicate())})


def table_sharding(mesh) -> list:
    """(r, n) twiddle tables: sharded over 'rns', replicated over 'coef'."""
    from torch.distributed.tensor import Shard
    return _placements(mesh, {RNS_AXIS: Shard(0)})


def const_sharding(mesh) -> list:
    """(r, 1) per-modulus constants."""
    return table_sharding(mesh)


def replicated(mesh) -> list:
    return _placements(mesh, {})


collectives: list[tuple[str, tuple]] = []


def all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum x over `group` in place (and return it), logged in
    `collectives`."""
    collectives.append(("all_reduce", tuple(x.shape)))
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def all_gather(x: torch.Tensor, group=None, dim: int = -2) -> torch.Tensor:
    """The ranks' x tiled along `dim` in rank order (jax.lax.all_gather(...,
    tiled=True)), logged in `collectives` with the gathered shape.  A list
    all_gather then a cat: gloo's all_gather_into_tensor is not relied on."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    shape = list(x.shape)
    shape[dim] *= len(parts)
    collectives.append(("all_gather", tuple(shape)))
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)
