"""The ('rns', 'coef') device mesh, DTensor placements, and the counted
collectives of the sharded programs.

Counterpart of `ntt_cuda_tpu/parallel/mesh.py`.  The reference's RNS
modulus batching (its grid-y axis) maps onto the 'rns' mesh axis, which is
embarrassingly parallel apart from the BEHZ reduce and the last-modulus
broadcast; the coefficient axis ('coef') is the transform's split.  A JAX
PartitionSpec becomes a DTensor placement list, one entry per mesh axis:
P('rns') on an (r, n) tensor is [Shard(0)] on a 1-D ('rns',) mesh, and on
a (2, r, n) tensor [Shard(1)].

`all_reduce`, `all_gather` and `ppermute` are the only ways the sharded
programs talk across ranks.  Each call is logged in `collectives` as
("all_reduce", shape), ("all_gather", gathered shape) or ("ppermute",
shape) before it runs (clear the list to start a count): torch has no
compiled program to inspect, so this log stands in for the JAX package's
`lowered_*` HLO counts (tests/test_collectives.py), as the launch
registry (utils/tracing.py) does for the kernels' launches.
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


def gather_whole(x) -> torch.Tensor:
    """A DTensor's whole value: its local block gathered (all_gather) over
    each mesh axis it is sharded on, none where the axis has one rank."""
    local, m = x.to_local(), x.device_mesh
    for i, pl in enumerate(x.placements):
        if pl.is_shard() and m.size(i) > 1:
            local = all_gather(local, m.get_group(i), dim=pl.dim)
    return local


_pair_groups: dict = {}


def _pair_group(a: int, b: int):
    """The 2-member process group of global ranks a and b, made at first
    use by the two of them alone (use_local_synchronization)."""
    world = dist.group.WORLD
    key = (id(world), min(a, b), max(a, b))
    g = _pair_groups.get(key)
    if g is None:
        g = dist.new_group(list(key[1:]), use_local_synchronization=True)
        _pair_groups[key] = g
    return g


def ppermute(x: torch.Tensor, pairs, group=None) -> torch.Tensor:
    """jax.lax.ppermute over `group` for pairwise exchanges, the only kind
    the transforms' cross stages make: each rank of `pairs` (ranks in the
    group) sends its x to the rank it receives from, and gets that rank's
    x.  Logged in `collectives` as ("ppermute", shape).  It is one
    all_gather over the pair's own 2-member group, which moves the bytes
    of one send and one receive and takes CUDA tensors on gloo too, whose
    send / recv refuse device memory ("writev: Bad address")."""
    group = group if group is not None else dist.group.WORLD
    me = dist.get_rank(group)
    dst = [d for s, d in pairs if s == me]
    src = [s for s, d in pairs if d == me]
    if len(dst) != 1 or dst != src or dst[0] == me:
        raise ValueError(f"ppermute takes pairwise exchanges only: rank {me} "
                         f"in {pairs}")
    x = x.contiguous()
    collectives.append(("ppermute", tuple(x.shape)))
    a = dist.get_global_rank(group, me)
    b = dist.get_global_rank(group, dst[0])
    parts = [torch.empty_like(x) for _ in range(2)]
    dist.all_gather(parts, x, group=_pair_group(a, b))
    return parts[int(b > a)]
