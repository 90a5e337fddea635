"""Carry keys, ciphertexts and parameters between the JAX package and the
port, exactly.

The JAX package holds u64 residues as numpy/jax `uint64`; the port holds
the same bit patterns in `torch.int64`.  Both directions reinterpret the
bits, so every value round-trips unchanged.  Parameters cross as the six
fields that define a set (name, n, q, psi, t, gamma); the port recomputes
every derived constant from them.  The sharded programs' keys and
ciphertexts cross as full arrays: `to_dtensor` gives one rank its rows
(and, on an ('rns', 'coef') mesh, its coefficients) of a JAX key or padded
ciphertext as a DTensor (no collective), and
`from_dtensor` brings a DTensor back whole through `full_tensor()`.
"""

from __future__ import annotations

import numpy as np
import torch

from .cuda import default_device
from .params import BFVParams


def to_torch(x, device=None) -> torch.Tensor:
    """A uint64 array (numpy, jax or anything np.asarray takes) -> int64
    tensor with the same bits on `device`: None is the current CUDA device,
    and raises where there is none; "cpu" for the plain versions."""
    device = default_device(device, "convert.to_torch")
    a = np.array(x, dtype=np.uint64)     # a writable copy
    return torch.from_numpy(a.view(np.int64)).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """An int64 tensor on any device -> numpy uint64 with the same bits."""
    return t.detach().to("cpu", torch.int64).contiguous().numpy().view(np.uint64)


def params_from(p) -> BFVParams:
    """A BFVParams-like object (name, n, q, psi, t, gamma), such as the JAX
    package's, -> the port's BFVParams."""
    return BFVParams(name=str(p.name), n=int(p.n),
                     q=tuple(int(q) for q in p.q),
                     psi=tuple(int(x) for x in p.psi),
                     t=int(p.t), gamma=int(p.gamma))


def to_dtensor(x, mesh, dim: int | None, coef_dim: int | None = None):
    """A full uint64 array (a JAX key or padded ciphertext) -> this rank's
    DTensor on `mesh`, on the mesh's device: on an ('rns',) mesh, rows
    [lo, hi) of axis `dim` as Shard(dim), or the whole as Replicate() for
    dim None; on an ('rns', 'coef') mesh also the rank's coefficient range
    of axis `coef_dim` as Shard(coef_dim) (Replicate() for None).  Each
    rank slices its own block; nothing is sent."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    t = to_torch(x, device="cpu")
    placements = []
    for i, name in enumerate(mesh.mesh_dim_names or ("rns",)):
        d = coef_dim if name == "coef" else dim
        if d is None:
            placements.append(Replicate())
            continue
        parts, idx = mesh.size(i), mesh.get_local_rank(i)
        if t.shape[d] % parts:
            raise ValueError(f"axis {d} of length {t.shape[d]} does not "
                             f"split over {parts} ranks")
        w = t.shape[d] // parts
        t = t.narrow(d, idx * w, w)
        placements.append(Shard(d))
    return DTensor.from_local(t.contiguous().to(mesh.device_type), mesh,
                              placements, run_check=False)


def from_dtensor(x) -> np.ndarray:
    """A DTensor -> its full value as numpy uint64 (an all-gather over the
    mesh for a sharded one: every rank must call it)."""
    return to_numpy(x.full_tensor())
