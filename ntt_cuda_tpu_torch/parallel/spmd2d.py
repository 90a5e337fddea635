"""2-D sharded BFV programs over an ('rns', 'coef') mesh, on
torch.distributed.

Counterpart of `ntt_cuda_tpu/parallel/spmd2d.py`: parallel/spmd.py's
modulus sharding (each rank owns r/R moduli, rows [lo, hi)) combined with
parallel/coef_kernels.py's coefficient sharding (each rank owns S = n/C
coefficients, [c S, (c + 1) S)).  Rank (i, c) holds the (r/R, n/C) block
of every polynomial and runs the stage kernels on it.  Traffic per op:

  * every transform: log2 C ppermutes over 'coef' (the cross stages);
  * keygen: ppermutes only, 3 log2 C;
  * encrypt: 2 log2 C ppermutes and one all-reduce over 'rns' of the
    (2, S) adjusted last residue;
  * decrypt: 2 log2 C ppermutes and one all-reduce over 'rns' of the
    (3, S) BEHZ partial sums.

Each rank draws exactly its (modulus range x coefficient range) slice of
the Salsa20 stream through K1's block counter, so the draws equal the
single card's.  Ciphertexts keep the padded (2, r, n) layout of
parallel/spmd.py, the dropped modulus's slot garbage.

Keys and ciphertexts are DTensors on the 2-D mesh: sk (r, n) [Shard(0),
Shard(1)], pk and ciphertexts (2, r, n) [Shard(1), Shard(2)], plaintexts
(n,) [Replicate(), Shard(0)].  A plain full tensor or array passed in is
sliced to the rank's block where it lies.

The kernels: K1 (the draws), kernels 7 and 8 with the shard offset and
the cross-stage glue (coef_kernels), kernel 16 (encrypt_tail_padded) and
kernel 17 (decrypt_tail_partial); on the CPU their plain versions.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from .. import cuda
from ..models.bfv import check_residues
from ..ops import bfv_tail, modmath, poly, sampling
from ..ops.modmath import I64
from ..params import BFVParams
from . import mesh as mesh_mod
from . import multihost, sharded
from .coef_kernels import CoefShardedNTT

# The smallest shard: n / C a multiple of 2 * 128, the JAX package's
# bound (its four-step tile), which also keeps every draw slice whole
# Salsa20 blocks.
SHARD_QUANTUM = 2 * 128


@dataclasses.dataclass(frozen=True)
class Spmd2DBFVContext:
    """One rank's state of the 2-D program for one parameter set.  Every
    rank of the mesh builds it and calls each op together."""

    params: BFVParams
    mesh: object                    # ('rns', 'coef') DeviceMesh
    device: torch.device
    rns_index: int                  # i on 'rns'
    coef_index: int                 # c on 'coef'
    R: int
    C: int
    cnt: CoefShardedNTT             # the rank's moduli over the full n
    tail_consts: bfv_tail.PaddedTailConsts
    dec_consts: bfv_tail.DecPartialConsts

    @staticmethod
    def build(params: BFVParams, mesh=None, device=None) -> "Spmd2DBFVContext":
        """`mesh` None is multihost.pod_mesh() over the default process
        group, which must be initialized.  `device` None is this rank's
        current CUDA device; "cpu" runs the kernels' plain versions."""
        if params.t & (params.t - 1):
            raise ValueError("the 2-D program runs the padded tails, which "
                             "assume a power-of-two t")
        if params.n > cuda.TRANSFORM_MAX_N:
            raise NotImplementedError(
                f"n={params.n} > {cuda.TRANSFORM_MAX_N}: no transform kernel "
                f"takes it")
        if mesh is None and not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(
                "Spmd2DBFVContext.build: no process group is initialized; "
                "call parallel.multihost.initialize(...) first or pass a mesh")
        device = cuda.default_device(device, "Spmd2DBFVContext.build")
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if mesh is None:
            mesh = multihost.pod_mesh(device_type=device.type)
        names = (mesh_mod.RNS_AXIS, mesh_mod.COEF_AXIS)
        if tuple(mesh.mesh_dim_names or ()) != names:
            raise ValueError(f"Spmd2DBFVContext needs an {names} mesh, got "
                             f"axes {mesh.mesh_dim_names}")
        R, C = mesh.size(0), mesh.size(1)
        sharded.log2_shards(C)
        if params.r % R:
            raise ValueError(f"r={params.r} not divisible by rns={R}")
        if params.n % (C * SHARD_QUANTUM):
            raise ValueError(f"n={params.n} too small for coef={C}")
        i = mesh.get_local_rank(mesh_mod.RNS_AXIS)
        c = mesh.get_local_rank(mesh_mod.COEF_AXIS)
        rl = params.r // R
        lo, hi = i * rl, (i + 1) * rl
        return Spmd2DBFVContext(
            params=params, mesh=mesh, device=device, rns_index=i,
            coef_index=c, R=R, C=C,
            cnt=CoefShardedNTT.build(params.q[lo:hi], params.psi[lo:hi],
                                     params.n, C, c, device),
            tail_consts=bfv_tail.build_tail_consts_padded(params, lo, hi,
                                                          device),
            dec_consts=bfv_tail.build_dec_tail_consts_padded(
                params, lo, hi, device=device))

    # -- the rank's block and the DTensor boundary ------------------------

    @property
    def rl(self) -> int:
        return self.params.r // self.R

    @property
    def lo(self) -> int:
        return self.rns_index * self.rl

    @property
    def hi(self) -> int:
        return self.lo + self.rl

    @property
    def S(self) -> int:
        return self.params.n // self.C

    @property
    def ms(self) -> modmath.ModulusSet:
        return self.cnt.tables.ms

    def _exchange(self):
        return sharded.exchange_over(
            self.mesh.get_group(mesh_mod.COEF_AXIS), self.C)

    def _placements(self, rns_dim: int | None, coef_dim: int) -> list:
        from torch.distributed.tensor import Replicate, Shard
        return [Replicate() if rns_dim is None else Shard(rns_dim),
                Shard(coef_dim)]

    def _dtensor(self, local: torch.Tensor, rns_dim: int | None,
                 coef_dim: int):
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(local, self.mesh,
                                  self._placements(rns_dim, coef_dim),
                                  run_check=False)

    def _local(self, name: str, x, shape: tuple, rns_dim: int | None,
               coef_dim: int, hint: str = "") -> torch.Tensor:
        """The rank's block of a (global) `shape` argument as a contiguous
        int64 tensor on the device: rows [lo, hi) of axis rns_dim (all for
        None) and coefficients [c S, (c + 1) S) of axis coef_dim.  A
        DTensor gives its local tensor; a full tensor or array is sliced
        where it lies."""
        from torch.distributed.tensor import DTensor
        if isinstance(x, DTensor):
            want = self._placements(rns_dim, coef_dim)
            if x.device_mesh != self.mesh or list(x.placements) != want:
                raise ValueError(f"{name}: a DTensor on {x.device_mesh} with "
                                 f"placements {x.placements}, expected "
                                 f"{want} on this context's mesh")
            if tuple(x.shape) != tuple(shape):
                raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                                 f"{tuple(x.shape)}" + (f" — {hint}" if hint
                                                         else ""))
            return x.to_local().to(device=self.device,
                                   dtype=I64).contiguous()
        x = check_residues(name, x, shape, hint)
        if rns_dim is not None:
            x = x.narrow(rns_dim, self.lo, self.rl)
        x = x.narrow(coef_dim, self.coef_index * self.S, self.S)
        return x.to(self.device).contiguous()

    # -- the programs -----------------------------------------------------

    def keygen(self, nonce=0):
        """-> sk (r, n) [Shard(0), Shard(1)], pk (2, r, n) [Shard(1),
        Shard(2)], NTT domain, equal to the single-card keygen.  Three
        sharded transforms, 3 log2 C ppermutes, no all-reduce."""
        sampling.check_user_nonce(nonce)
        p, ms, ex = self.params, self.ms, self._exchange()
        s_b, a, e_d = sampling.keygen_draws_rank(
            p.n, p.r, self.lo, self.hi, ms, nonce=int(nonce),
            block=self.coef_index, S=self.S)
        sk = self.cnt.forward(sampling.small_res(s_b, ms.q), ex)
        pk0 = self.cnt.inverse_mul(a, sk, ex)
        pk0 = poly.poly_add_negate(pk0, sampling.small_res(e_d, ms.q), ms)
        pk0 = self.cnt.forward(pk0, ex)
        return (self._dtensor(sk, 0, 1),
                self._dtensor(torch.stack([pk0, a]), 1, 2))

    def encrypt(self, pk, m_poly, nonce=0):
        """pk (2, r, n) NTT domain, m_poly (n,) in [0, t) -> padded
        ciphertext (2, r, n) [Shard(1), Shard(2)], live rows equal to the
        single-card encrypt.  Two sharded transforms, one all-reduce of
        the adjusted last residue, kernel 16."""
        sampling.check_user_nonce(nonce)
        p, ms, ex = self.params, self.ms, self._exchange()
        pk = self._local("pk", pk, (2, p.r, p.n), 1, 2,
                         "keygen returns the NTT-domain (2, r, n) pk")
        m_poly = self._local("m_poly", m_poly, (p.n,), None, 0,
                             f"one plaintext value in [0, t) per "
                             f"coefficient, n={p.n}")
        u_b, e_d = sampling.encrypt_draws_slice(
            p.n, self.coef_index, self.S, nonce=int(nonce),
            device=self.device)
        u = self.cnt.forward(sampling.small_res(u_b, ms.q), ex)
        c = self.cnt.inverse_mul(pk, u, ex)                   # (2, rl, S)
        e = sampling.small_res(e_d, ms.q)                     # (2, rl, S)
        ra = torch.zeros((2, self.S), dtype=I64, device=self.device)
        if self.hi == p.r:           # the dropped modulus's owner
            ql = p.q[-1]
            ra = modmath.add_mod_lazy_gt(c[:, -1], e[:, -1], ql)  # strict >
            ra = ra + p.half_last_modulus
            ra = ra - ql * (ra >= ql).to(I64)
        mesh_mod.all_reduce(ra, self.mesh.get_group(mesh_mod.RNS_AXIS))
        return self._dtensor(bfv_tail.encrypt_tail_padded(
            c, e, ra, m_poly, self.tail_consts), 1, 2)

    def decrypt(self, sk, ct):
        """sk (r, n) NTT domain, ct (2, r, n) padded -> plaintext (n,)
        [Replicate(), Shard(0)].  Two sharded transforms, kernel 17 on the
        rank's block, one all-reduce of the BEHZ partials over 'rns', the
        rounding on every rank."""
        p, ex = self.params, self._exchange()
        sk = self._local("sk", sk, (p.r, p.n), 0, 1,
                         "keygen returns the NTT-domain (r, n) sk")
        ct = self._local("ct", ct, (2, p.r, p.n), 1, 2,
                         "SPMD ciphertexts use the padded (2, r, n) "
                         "reference layout")
        x = self.cnt.forward(ct[1].contiguous(), ex)
        x = self.cnt.inverse_mul(x, sk, ex)
        x_t, x_g = bfv_tail.decrypt_tail_partial(x, ct[0].contiguous(),
                                                 self.dec_consts)
        x_t, x_g = bfv_tail.psum_behz_partials(
            x_t, x_g, self.mesh.get_group(mesh_mod.RNS_AXIS), p)
        return self._dtensor(bfv_tail.dec_round_from_sums(x_t, x_g, p),
                             None, 0)
