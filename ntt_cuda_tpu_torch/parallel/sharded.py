"""Coefficient-sharded negacyclic NTT over the 'coef' axis of an ('rns',
'coef') mesh, in plain tensor ops.

Counterpart of `ntt_cuda_tpu/parallel/sharded.py` (all XLA there, no
Pallas kernel).  Shard c of C = 2^logc holds coefficients [c S, (c + 1) S)
of an n-point transform, S = n / C, for the rank's moduli:

* forward stages s < log2 C cross the shard boundary: the butterfly
  partner is shard c ^ (C >> (s + 1)), fetched with one pairwise
  exchange (`mesh.ppermute`), and the whole shard takes one butterfly with
  the single twiddle psi[2^s + c // (2k)];
* forward stages s >= log2 C stay inside the shard: the single-card stage
  loop with the twiddle base offset by the shard (local group j of stage s
  reads psi[2^s + c m + j], m = S / (2 step));
* the inverse mirrors it, local GS stages first, the cross ones last, each
  stage halving (n^-1 folded into the stages, as ops/ntt.py does).

Outputs equal the single-card transform bit for bit at any C.  The
per-stage functions take the partner's tensor, so one process can drive
all C shards stage by stage; `forward_shard` / `inverse_shard` take an
`exchange(x, k)` that returns shard (c ^ k)'s x.  This module is also the
plain version of `parallel/coef_kernels.py`, whose cross stages skip the
halving because its local inverse kernel multiplies by the global n^-1.
Tensors: x (..., r, S), the residue axis second to last; tables the
rank's moduli over the full n (ops/ntt.NTTTables).
"""

from __future__ import annotations

import torch

from ..ops import modmath
from ..ops.ntt import NTTTables, _col


def xor_pairs(C: int, k: int) -> list[tuple[int, int]]:
    """The exchange of a cross stage: shard i sends to shard i ^ k."""
    return [(i, i ^ k) for i in range(C)]


def log2_shards(C: int) -> int:
    if C < 1 or C & (C - 1):
        raise ValueError(f"the coefficient axis must be a power of two, "
                         f"got C={C}")
    return C.bit_length() - 1


def cross_stride(C: int, s: int) -> int:
    """k = C >> (s + 1): the shard distance of cross stage s."""
    return C >> (s + 1)


def cross_twiddle(C: int, s: int, block: int) -> int:
    """The one twiddle index of cross stage s on shard `block`: 2^s + the
    butterfly group, the same on both sides of the pair."""
    return (1 << s) + block // (2 * cross_stride(C, s))


def u_side(C: int, s: int, block: int) -> bool:
    """Whether shard `block` holds the u (first) half of its pair."""
    return (block & cross_stride(C, s)) == 0


def _consts(tables: NTTTables):
    return _col(tables.ms.q, 1), _col(tables.ms.qinv_neg, 1)


def cross_forward_stage(x, partner, tables: NTTTables, C: int, s: int,
                        block: int):
    """One cross-shard CT stage on shard `block` (JAX
    `_cross_forward_stage`): u + w v on the u side, u - w v on the other."""
    q, qinv = _consts(tables)
    w = _col(tables.psi_mont[:, cross_twiddle(C, s, block)], 1)
    if u_side(C, s, block):
        return modmath.add_mod(x, modmath.mont_mul(partner, w, q, qinv), q)
    return modmath.sub_mod(partner, modmath.mont_mul(x, w, q, qinv), q)


def cross_inverse_stage(x, partner, tables: NTTTables, C: int, s: int,
                        block: int, halve: bool = True):
    """One cross-shard GS stage on shard `block` (JAX
    `_cross_inverse_stage`): u + v on the u side, (u - v) w^-1 on the
    other; halved when `halve` (the plain local stages' convention)."""
    q, qinv = _consts(tables)
    if u_side(C, s, block):
        out = modmath.add_mod(x, partner, q)
    else:
        w = _col(tables.psiinv_mont[:, cross_twiddle(C, s, block)], 1)
        out = modmath.mont_mul(modmath.sub_mod(partner, x, q), w, q, qinv)
    return modmath.halve_mod(out, q) if halve else out


def local_forward_stages(x, tables: NTTTables, C: int, block: int):
    """Forward stages log2 C .. log2 n - 1 on shard `block`'s (..., r, S)
    slice, the twiddle base offset by the shard."""
    n, logn = tables.n, tables.logn
    S = n // C
    shape, lead = x.shape, x.shape[:-1]
    q, qinv = _col(tables.ms.q, 2), _col(tables.ms.qinv_neg, 2)
    for s in range(log2_shards(C), logn):
        length, step = 1 << s, n >> (s + 1)
        m = S // (2 * step)
        xr = x.reshape(lead + (m, 2, step))
        lo = length + block * m
        w = tables.psi_mont[:, lo:lo + m, None]
        t = modmath.mont_mul(xr[..., 1, :], w, q, qinv)
        u = xr[..., 0, :]
        x = torch.stack([modmath.add_mod(u, t, q),
                         modmath.sub_mod(u, t, q)], dim=-2).reshape(shape)
    return x


def local_inverse_stages(x, tables: NTTTables, C: int, block: int):
    """Inverse GS stages log2 n - 1 .. log2 C on shard `block`'s slice,
    each halving."""
    n, logn = tables.n, tables.logn
    S = n // C
    shape, lead = x.shape, x.shape[:-1]
    q, qinv = _col(tables.ms.q, 2), _col(tables.ms.qinv_neg, 2)
    for s in reversed(range(log2_shards(C), logn)):
        length, step = 1 << s, n >> (s + 1)
        m = S // (2 * step)
        xr = x.reshape(lead + (m, 2, step))
        lo = length + block * m
        w = tables.psiinv_mont[:, lo:lo + m, None]
        u, v = xr[..., 0, :], xr[..., 1, :]
        d = modmath.mont_mul(modmath.sub_mod(u, v, q), w, q, qinv)
        x = torch.stack([modmath.halve_mod(modmath.add_mod(u, v, q), q),
                         modmath.halve_mod(d, q)], dim=-2).reshape(shape)
    return x


def forward_shard(x, tables: NTTTables, C: int, block: int, exchange):
    """Shard `block`'s part of the forward transform: the cross stages,
    each after exchange(x, k) fetched shard (block ^ k)'s x, then the
    local stages."""
    for s in range(log2_shards(C)):
        partner = exchange(x, cross_stride(C, s))
        x = cross_forward_stage(x, partner, tables, C, s, block)
    return local_forward_stages(x, tables, C, block)


def inverse_shard(x, tables: NTTTables, C: int, block: int, exchange):
    """Shard `block`'s part of the inverse: the local stages, then the
    cross stages in reverse, each halving."""
    x = local_inverse_stages(x, tables, C, block)
    for s in reversed(range(log2_shards(C))):
        partner = exchange(x, cross_stride(C, s))
        x = cross_inverse_stage(x, partner, tables, C, s, block)
    return x


def exchange_over(group, C: int):
    """exchange(x, k) over a coef process group of C ranks: one
    ppermute with shard (c ^ k)."""
    from . import mesh as mesh_mod

    def exchange(x, k):
        return mesh_mod.ppermute(x, xor_pairs(C, k), group)
    return exchange


def _make(mesh, n: int, shard_fn):
    from . import mesh as mesh_mod
    C = mesh.size(mesh.mesh_dim_names.index(mesh_mod.COEF_AXIS))
    block = mesh.get_local_rank(mesh_mod.COEF_AXIS)
    exchange = exchange_over(mesh.get_group(mesh_mod.COEF_AXIS), C)

    def fn(x, tables: NTTTables):
        if tables.n != n:
            raise ValueError(f"tables of n={tables.n}, expected {n}")
        if x.shape[-1] * C != n:
            raise ValueError(f"x: the shard's width is {n // C}, got "
                             f"{x.shape[-1]}")
        return shard_fn(x, tables, C, block, exchange)
    return fn


def sharded_ntt_forward(mesh, n: int):
    """fn(x, tables) -> this rank's part of the forward NTT.  x (..., rl,
    n / C) is the rank's block of an (..., r, n) tensor sharded over
    ('rns', 'coef'); tables the rank's rl moduli over the full n.  Every
    rank of the mesh calls it together (log2 C ppermutes over 'coef')."""
    return _make(mesh, n, forward_shard)


def sharded_ntt_inverse(mesh, n: int):
    """The inverse counterpart of sharded_ntt_forward."""
    return _make(mesh, n, inverse_shard)
