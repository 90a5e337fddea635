"""Coefficient-sharded NTT with the stage kernels per shard.

Counterpart of `ntt_cuda_tpu/parallel/coef_pallas.py`.  Shard c of C =
2^logc holds coefficients [c S, (c + 1) S), S = n / C.  The log2 C stages
whose butterflies cross the shard boundary run as cross stages (one
`mesh.ppermute` each, then one elementwise butterfly with a single twiddle
per modulus); every stage below that boundary is one launch of the stage
kernels (kernels 7 and 8, csrc/ntt_stage.cu) with the shard offset: the
local transform's twiddle row [m, 2m) is the full table's row [m (C + c),
m (C + c) + m), so the launch reads the full-n tables with the base C + c
(block j of a polynomial's cluster of B blocks: B (C + c) + j).  The TPU
kernel gathers per-shard four-step tables instead
(coef_pallas.py `_gather_shard_tables`, a tiling artefact); here there is
no per-shard table.

The inverse's local launch ends with the global n's n^-1 (the full
tables' consts), so the cross GS stages after it do not halve, as
`coef_pallas.cross_inv` does.  The cross butterfly is glue, not a ported
TPU kernel (XLA in the JAX package): on the card it is one elementwise
launch (csrc/ntt_stage.cu `ntt_cross_stage`), on the CPU
`parallel/sharded.py`'s plain stage.

`exchange(x, k)` returns shard (c ^ k)'s x: `mesh.ppermute` over the coef
group in a sharded program (`sharded.exchange_over`), or the partner's
tensor handed in where one process drives every shard.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import cuda
from ..ops import modmath, ntt, ntt_stage
from ..ops.modmath import I64
from ..ops.ntt import NTTTables
from . import sharded


def _local_device(name: str, x: torch.Tensor, tables: NTTTables, logc: int):
    dev = cuda.kernel_device(name, x, tables, cuda.TRANSFORM_MAX_N << logc)
    if (tables.n >> logc) > cuda.TRANSFORM_MAX_N:
        raise ValueError(f"{name}: a shard of {tables.n >> logc} points is "
                         f"over the kernels' {cuda.TRANSFORM_MAX_N}")
    cuda.require("x", x, I64, tuple(x.shape), dev)
    return dev


def _check_local(name: str, x, tables: NTTTables, logc: int) -> None:
    S = tables.n >> logc
    if x.dim() not in (2, 3) or tuple(x.shape[-2:]) != (tables.r, S):
        raise ValueError(f"{name}: expected shape ({tables.r}, {S}) or "
                         f"(J, {tables.r}, {S}), got {tuple(x.shape)}")


def local_forward(x, tables: NTTTables, logc: int, shard: int):
    """The forward stages below the shard boundary of shard `shard` of
    2^logc: x (r, S) or (J, r, S) after the cross stages; tables the full
    n.  Kernel 7 with the shard offset, one launch."""
    _check_local("local_forward", x, tables, logc)
    if x.device.type == "cpu":
        return sharded.local_forward_stages(x, tables, 1 << logc, shard)
    dev = _local_device("local_forward", x, tables, logc)
    out = torch.empty_like(x)
    ntt_stage.forward_launch(dev, x, None, out, tables, cuda.PRO_COPY,
                             logc=logc, shard=shard)
    local_forward.launches += 1
    return out


local_forward.launches = 0


def local_inverse_mul_plain(x, y, tables: NTTTables, C: int, shard: int):
    """The plain version of local_inverse_mul (C shards, not log2 C)."""
    out = sharded.local_inverse_stages(
        x if y is None else ntt.dyadic_mul(x, y, tables.ms), tables, C, shard)
    # the plain stages halve each local stage; the log2 C cross stages that
    # follow here do not, so their halvings come in now: 2^-log2 C
    q = tables.ms.q
    for _ in range(C.bit_length() - 1):
        out = modmath.halve_mod(out, q)
    return out


def local_inverse_mul(x, y, tables: NTTTables, logc: int, shard: int):
    """INTT's stages below the shard boundary of x (.) y (or of x alone,
    y None), times the global n^-1: x (r, S) or (J, r, S), y (r, S) shared
    or x's shape.  Kernel 8 (7 for y None) with the shard offset, one
    launch; the cross GS stages follow without halving."""
    _check_local("local_inverse_mul", x, tables, logc)
    if y is not None and tuple(y.shape) not in (tuple(x.shape),
                                                tuple(x.shape[-2:])):
        raise ValueError(f"y: expected shape {tuple(x.shape[-2:])} or "
                         f"{tuple(x.shape)}, got {tuple(y.shape)}")
    if x.device.type == "cpu":
        return local_inverse_mul_plain(x, y, tables, 1 << logc, shard)
    dev = _local_device("local_inverse_mul", x, tables, logc)
    if y is not None:
        cuda.require("y", y, I64, tuple(y.shape), dev)
    out = torch.empty_like(x)
    ntt_stage.inverse_launch(dev, x, y, None, out, tables, logc=logc,
                             shard=shard)
    local_inverse_mul.launches += 1
    return out


local_inverse_mul.launches = 0


def local_keyswitch_acc_plain(dhat, ksk, tables: NTTTables, C: int,
                              shard: int):
    """The plain version of local_keyswitch_acc (C shards, not log2 C):
    keyswitch_front_plain's accumulate, then local_inverse_mul_plain's
    stages and halvings."""
    ms = tables.ms
    acc = [None, None]
    for j in range(dhat.shape[0]):
        for h in (0, 1):
            t = ntt.dyadic_mul(dhat[j], ksk[h, j], ms)
            acc[h] = t if acc[h] is None else modmath.add_mod(acc[h], t, ms.q)
    return local_inverse_mul_plain(torch.stack(acc), None, tables, C, shard)


def local_keyswitch_acc(dhat, ksk, tables: NTTTables, logc: int, shard: int):
    """The key switch's accumulate on a coefficient shard: the INTT stages
    below the shard boundary of sum_j dhat_j (.) ksk[h, j] for h = 0, 1,
    times the global n^-1.  dhat (k, r, S) the digits' forwards, ksk (2, k,
    r, S) the shard's key block -> (2, r, S); the cross GS stages follow
    without halving.  Kernel 20's second launch (csrc/ntt_stage.cu
    PRO_KSACC) with the shard offset."""
    k = dhat.shape[0] if dhat.dim() == 3 else 0
    if k < 1:
        raise ValueError(f"dhat: expected shape (k, {tables.r}, "
                         f"{tables.n >> logc}), got {tuple(dhat.shape)}")
    _check_local("local_keyswitch_acc", dhat[0], tables, logc)
    S = tables.n >> logc
    if tuple(ksk.shape) != (2, k, tables.r, S):
        raise ValueError(f"ksk: expected shape {(2, k, tables.r, S)}, got "
                         f"{tuple(ksk.shape)}")
    if dhat.device.type == "cpu":
        return local_keyswitch_acc_plain(dhat, ksk, tables, 1 << logc, shard)
    dev = _local_device("local_keyswitch_acc", dhat, tables, logc)
    cuda.require("ksk", ksk, I64, tuple(ksk.shape), dev)
    out = torch.empty((2, tables.r, S), dtype=I64, device=dev)
    cuda.launch("ntt_stage_inverse_cluster", dev, dhat.data_ptr(),
                ksk.data_ptr(), None, out.data_ptr(), *tables.kernel_args(),
                cuda.PRO_KSACC, k, 2 * tables.r, tables.r,
                S.bit_length() - 1, None, logc, shard, 0)
    local_keyswitch_acc.launches += 1
    return out


local_keyswitch_acc.launches = 0


def cross_stage(x, partner, tables: NTTTables, C: int, s: int, block: int,
                inverse: bool):
    """Cross stage s of shard `block` with the partner shard's tensor: CT
    forward, or GS inverse without halving.  The glue launch on the card,
    sharded.py's plain stage on the CPU."""
    if tuple(partner.shape) != tuple(x.shape):
        raise ValueError(f"partner: shape {tuple(partner.shape)}, expected "
                         f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        if inverse:
            return sharded.cross_inverse_stage(x, partner, tables, C, s,
                                               block, halve=False)
        return sharded.cross_forward_stage(x, partner, tables, C, s, block)
    logc = sharded.log2_shards(C)
    _check_local("cross_stage", x, tables, logc)
    dev = _local_device("cross_stage", x, tables, logc)
    cuda.require("partner", partner, I64, tuple(x.shape), dev)
    out = torch.empty_like(x)
    S = tables.n >> logc
    cuda.launch("ntt_cross_stage", dev, x.data_ptr(), partner.data_ptr(),
                out.data_ptr(), *tables.kernel_args(), int(inverse),
                int(sharded.u_side(C, s, block)),
                sharded.cross_twiddle(C, s, block), x.numel() // S, tables.r,
                S.bit_length() - 1, logc)
    cross_stage.launches += 1
    return out


cross_stage.launches = 0


def cross_fwd(x, tables: NTTTables, C: int, block: int, exchange):
    """The log2 C cross CT stages of shard `block` (before the local
    forward)."""
    for s in range(sharded.log2_shards(C)):
        x = cross_stage(x, exchange(x, sharded.cross_stride(C, s)), tables, C,
                        s, block, inverse=False)
    return x


def cross_inv(x, tables: NTTTables, C: int, block: int, exchange):
    """The log2 C cross GS stages of shard `block` (after the local
    inverse), no halving."""
    for s in reversed(range(sharded.log2_shards(C))):
        x = cross_stage(x, exchange(x, sharded.cross_stride(C, s)), tables, C,
                        s, block, inverse=True)
    return x


@dataclasses.dataclass(frozen=True)
class CoefShardedNTT:
    """One shard's coefficient-sharded transform: the rank's moduli over
    the full n, shard `block` of C."""

    tables: NTTTables
    C: int
    block: int

    @staticmethod
    def build(qs, psis, n: int, C: int, block: int,
              device=None) -> "CoefShardedNTT":
        """`device` None is the current CUDA device; "cpu" runs the plain
        versions."""
        logc = sharded.log2_shards(C)
        if not 0 <= block < C or n % C or n // C < 2:
            raise ValueError(f"shard {block} of C={C} over n={n}")
        if n >> logc > cuda.TRANSFORM_MAX_N:
            raise NotImplementedError(
                f"a shard of {n >> logc} points is over the kernels' "
                f"{cuda.TRANSFORM_MAX_N}")
        device = cuda.default_device(device, "CoefShardedNTT.build")
        return CoefShardedNTT(NTTTables.build(qs, psis, n, device), C, block)

    @property
    def logc(self) -> int:
        return sharded.log2_shards(self.C)

    def forward(self, x, exchange):
        """The shard's forward NTT: cross stages, then the local launch."""
        x = cross_fwd(x, self.tables, self.C, self.block, exchange)
        return local_forward(x, self.tables, self.logc, self.block)

    def inverse(self, x, exchange):
        """The shard's inverse NTT: the local launch, then cross stages."""
        return self.inverse_mul(x, None, exchange)

    def inverse_mul(self, x, y, exchange):
        """INTT(x (.) y) on the shard (y None: INTT(x)): the dyadic product
        is elementwise, so it commutes with the sharding and fuses into the
        local launch."""
        x = local_inverse_mul(x, y, self.tables, self.logc, self.block)
        return cross_inv(x, self.tables, self.C, self.block, exchange)
