"""Carry keys, ciphertexts and parameters between the JAX package and the
port, exactly.

The JAX package holds u64 residues as numpy/jax `uint64`; the port holds
the same bit patterns in `torch.int64`.  Both directions reinterpret the
bits, so every value round-trips unchanged.  Parameters cross as the six
fields that define a set (name, n, q, psi, t, gamma); the port recomputes
every derived constant from them.
"""

from __future__ import annotations

import numpy as np
import torch

from .params import BFVParams


def to_torch(x, device="cpu") -> torch.Tensor:
    """A uint64 array (numpy, jax or anything np.asarray takes) -> int64
    tensor with the same bits on `device`."""
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
