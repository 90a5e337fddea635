"""RNS-sharded BFV programs over the 'rns' mesh axis, on torch.distributed.

Counterpart of `ntt_cuda_tpu/parallel/spmd.py`.  Each rank owns r/R of the
RNS moduli, rows [lo, hi): it builds the transform tables and tail
constants of those rows alone, runs the kernels on them, and draws exactly
its own slice of the Salsa20 keystream (counter mode).  The only traffic
between ranks is

  * encrypt: one all-reduce of the (2, n) adjusted last residue, sent by
    the dropped modulus's owner for the modulus drop (divide_and_round,
    encryption's one cross-modulus dependency);
  * decrypt: one all-reduce of the (3, n) BEHZ partial sums (x_t, and x_g
    split into 32-bit halves so that no sum wraps int64;
    bfv_tail.psum_behz_partials);
  * mod_switch_to_next: one all-reduce of the (L, n) dropped residue.

Keygen has none.  Ciphertexts keep the reference's padded layout, (2, r,
n) with the dropped modulus's slot garbage (bfv_encryption.cuh:216-222),
so every rank's slice has the same shape.

Keys and ciphertexts are DTensors on the ('rns',) mesh, the counterpart of
the JAX package's globally sharded arrays: sk (r, n) [Shard(0)], pk and
ciphertexts (L, r, n) [Shard(1)], plaintexts (n,) [Replicate()].  The
kernels run on `.to_local()`, and results come back through
`DTensor.from_local(..., run_check=False)`.  A plain full tensor or array
passed in is sliced to the rank's rows where it lies, with no scatter.
Every collective goes through `mesh.all_reduce`, which logs it: the
counterpart of the JAX package's `lowered_*` programs, whose HLO
tests/test_collectives.py counts.

The kernels: K1 (the draws), K4 (keygen_fused), kernel 18 (encrypt_front),
kernel 16 (encrypt_tail_padded), K3 (half_polymul, decrypt's front) and
kernel 17 (decrypt_tail_partial), each on the rank's rows; on the CPU their
plain versions.  The ciphertext ops and mod_switch_to_next are plain tensor
ops on the device, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.distributed as dist

from .. import cuda
from ..models.bfv import check_residues
from ..ops import bfv_tail, fused_ops, modmath, ntt, sampling
from ..ops.modmath import I64
from ..params import BFVParams
from ..utils import hostmath as hm
from . import mesh as mesh_mod


@dataclasses.dataclass(frozen=True)
class SpmdBFVContext:
    """One rank's state of the RNS-sharded program for one parameter set.
    Every rank of the mesh builds it and calls each op together."""

    params: BFVParams
    mesh: object                            # 1-D ('rns',) DeviceMesh
    device: torch.device
    index: int                              # the rank's place on 'rns'
    shards: int                             # R
    tables: ntt.NTTTables                   # moduli [lo, hi)
    tail_consts: bfv_tail.PaddedTailConsts
    dec_consts: bfv_tail.DecPartialConsts
    _cache: dict = dataclasses.field(default_factory=dict, compare=False,
                                     repr=False)

    @staticmethod
    def build(params: BFVParams, mesh=None, device=None) -> "SpmdBFVContext":
        """`mesh` None is a 1-D ('rns',) mesh over the default process
        group, which must be initialized (multihost.initialize).  `device`
        None is this rank's current CUDA device; "cpu" runs the kernels'
        plain versions."""
        t = params.t
        if t & (t - 1) and (t % 2 == 0 or t >= bfv_tail.T_MAX):
            raise ValueError("SPMD pipelines run the fused tails: t must be "
                             "a power of two or an odd batching prime "
                             "< 2^62")
        if params.n > cuda.TRANSFORM_MAX_N:
            raise NotImplementedError(
                f"n={params.n} > {cuda.TRANSFORM_MAX_N}: no transform kernel "
                f"takes it")
        if mesh is None and not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(
                "SpmdBFVContext.build: no process group is initialized; call "
                "parallel.multihost.initialize(...) first or pass a mesh")
        device = cuda.default_device(device, "SpmdBFVContext.build")
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if mesh is None:
            mesh = mesh_mod.rns_mesh(device.type)
        if tuple(mesh.mesh_dim_names or ()) != (mesh_mod.RNS_AXIS,):
            raise ValueError(f"SpmdBFVContext needs a 1-D ('rns',) mesh, got "
                             f"axes {mesh.mesh_dim_names}")
        R = mesh.size(0)
        if params.r % R != 0:
            raise ValueError(f"r={params.r} not divisible by {R} shards")
        index = mesh.get_local_rank(mesh_mod.RNS_AXIS)
        rl = params.r // R
        lo, hi = index * rl, (index + 1) * rl
        return SpmdBFVContext(
            params=params, mesh=mesh, device=device, index=index, shards=R,
            tables=ntt.NTTTables.build(params.q[lo:hi], params.psi[lo:hi],
                                       params.n, device),
            tail_consts=bfv_tail.build_tail_consts_padded(params, lo, hi,
                                                          device),
            dec_consts=bfv_tail.build_dec_tail_consts_padded(
                params, lo, hi, device=device))

    # -- the rank's rows and the DTensor boundary -------------------------

    @property
    def rl(self) -> int:
        return self.params.r // self.shards

    @property
    def lo(self) -> int:
        return self.index * self.rl

    @property
    def hi(self) -> int:
        return self.lo + self.rl

    @property
    def group(self):
        return self.mesh.get_group(mesh_mod.RNS_AXIS)

    def _dtensor(self, local: torch.Tensor, dim: int | None):
        """The rank's local tensor as a DTensor on the mesh: Shard(dim),
        or Replicate() for dim None."""
        from torch.distributed.tensor import DTensor, Replicate, Shard
        return DTensor.from_local(local, self.mesh,
                                  [Replicate() if dim is None else Shard(dim)],
                                  run_check=False)

    def _local(self, name: str, x, shape: tuple, dim: int | None,
               hint: str = "") -> torch.Tensor:
        """The rank's part of a (global) `shape` argument as a contiguous
        int64 tensor on the device: rows [lo, hi) of axis `dim` (the whole
        for dim None).  A DTensor gives its local tensor; a full tensor or
        array is sliced where it lies."""
        from torch.distributed.tensor import DTensor, Replicate, Shard
        if isinstance(x, DTensor):
            want = [Replicate() if dim is None else Shard(dim)]
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
        if dim is not None:
            x = x.narrow(dim, self.lo, self.rl)
        return x.to(self.device).contiguous()

    # -- the programs -----------------------------------------------------

    def keygen(self, nonce=0):
        """-> sk (r, n) [Shard(0)], pk (2, r, n) [Shard(1)], NTT domain,
        equal to the single-card keygen.  No collective: the s and e draws
        are computed on every rank, the uniform a from the rank's own
        keystream slice (sampling.keygen_draws_rank), then K4 on the
        rank's moduli."""
        sampling.check_user_nonce(nonce)
        p = self.params
        s_b, a, e_d = sampling.keygen_draws_rank(p.n, p.r, self.lo, self.hi,
                                                 self.tables.ms,
                                                 nonce=int(nonce))
        sk, pk0 = fused_ops.keygen_fused(s_b, a, e_d, self.tables)
        return self._dtensor(sk, 0), self._dtensor(torch.stack([pk0, a]), 1)

    def encrypt(self, pk, m_poly, nonce=0):
        """pk (2, r, n) NTT domain, m_poly (n,) in [0, t) -> padded
        ciphertext (2, r, n) [Shard(1)], the dropped modulus's slot
        garbage, live rows equal to the single-card encrypt.  Kernel 18,
        one all-reduce of the adjusted last residue, kernel 16."""
        sampling.check_user_nonce(nonce)
        p = self.params
        n = p.n
        pk = self._local("pk", pk, (2, p.r, n), 1,
                         "keygen returns the NTT-domain (2, r, n) pk")
        m_poly = self._local("m_poly", m_poly, (n,), None,
                             f"one plaintext value in [0, t) per "
                             f"coefficient, n={n}")
        u_b, e_d = sampling.encrypt_draws_compact(n, nonce=int(nonce),
                                                  device=self.device)
        c = fused_ops.encrypt_front(u_b, pk, self.tables)
        e = sampling.small_res(e_d, self.tables.ms.q)        # (2, rl, n)
        ra = torch.zeros((2, n), dtype=I64, device=self.device)
        if self.hi == p.r:           # the dropped modulus's owner
            ql = p.q[-1]
            x = modmath.add_mod_lazy_gt(c[:, -1], e[:, -1], ql)  # strict `>`
            ra = x + p.half_last_modulus
            ra = ra - ql * (ra >= ql).to(I64)
        mesh_mod.all_reduce(ra, self.group)
        return self._dtensor(bfv_tail.encrypt_tail_padded(
            c, e, ra, m_poly, self.tail_consts), 1)

    def add(self, ct_a, ct_b):
        """Homomorphic addition of padded ciphertexts: row-local exact
        mod-q add, no collective; pad rows stay padding."""
        a, b = self._ct_pair("add", ct_a, ct_b)
        return self._dtensor(modmath.add_mod(a, b, self.tables.ms.q), 1)

    def sub(self, ct_a, ct_b):
        """Homomorphic subtraction of padded ciphertexts (row-local)."""
        a, b = self._ct_pair("sub", ct_a, ct_b)
        return self._dtensor(modmath.sub_mod(a, b, self.tables.ms.q), 1)

    def _ct_pair(self, op: str, ct_a, ct_b):
        p = self.params
        shape = (2, p.r, p.n)
        hint = "SPMD ciphertexts use the padded (2, r, n) layout"
        return (self._local(f"{op} lhs", ct_a, shape, 1, hint),
                self._local(f"{op} rhs", ct_b, shape, 1, hint))

    def decrypt(self, sk, ct, level: int = 0):
        """sk (r, n) NTT domain, ct (2, r, n) padded -> plaintext (n,)
        [Replicate()].  K3 and kernel 17 on the rank's rows, one
        all-reduce of the BEHZ partials, the rounding on every rank.

        level > 0 decrypts a ciphertext mod-switched `level` times: the
        padded width stays r, the BEHZ conversion runs over the level's
        live chain q[:r - level] with every other row's part zeroed."""
        lp = _chain_params(self.params, level)
        x_t, x_g = self.decrypt_partials(sk, ct, level)
        x_t, x_g = bfv_tail.psum_behz_partials(x_t, x_g, self.group, lp)
        return self._dtensor(bfv_tail.dec_round_from_sums(x_t, x_g, lp), None)

    def decrypt_partials(self, sk, ct, level: int = 0):
        """decrypt up to the all-reduce: the rank's BEHZ partials (x_t,
        x_g), each (n,), from K3 and kernel 17 on its rows.  Summed over
        the group by bfv_tail.psum_behz_partials (any leading shape, so
        several ciphertexts' partials stacked take one all-reduce) and
        rounded by bfv_tail.dec_round_from_sums."""
        p = self.params
        sk = self._local("sk", sk, (p.r, p.n), 0,
                         "keygen returns the NTT-domain (r, n) sk")
        ct = self._local("ct", ct, (2, p.r, p.n), 1,
                         "SPMD ciphertexts use the padded (2, r, n) "
                         "reference layout")
        x = fused_ops.half_polymul(ct[1], sk, self.tables)
        return bfv_tail.decrypt_tail_partial(x, ct[0], self._dec_consts(level))

    def _dec_consts(self, level: int) -> bfv_tail.DecPartialConsts:
        """The rank's decrypt constants at `level` (cached): the level's
        chain over rows [lo, min(hi, r - level)), then q = 1 pad rows."""
        if level == 0:
            return self.dec_consts
        key = ("dec", level)
        dc = self._cache.get(key)
        if dc is None:
            cp = _chain_params(self.params, level)
            dc = bfv_tail.build_dec_tail_consts_padded(
                cp, self.lo, min(self.hi, cp.r), pad_to=self.hi,
                device=self.device)
            self._cache[key] = dc
        return dc

    def mod_switch_to_next(self, ct, level: int = 0):
        """SEAL's mod_switch_to_next on padded ciphertexts: each component
        of an (L, r, n) ciphertext at `level` is divided and rounded by the
        level's last live modulus q[r - 2 - level].  The padded width, and
        with it every rank's rows, stays: the live width shrinks to
        r - 2 - level and one more row becomes padding.  One all-reduce
        sends the dropped residue from its owner.  Decrypt the result with
        decrypt(..., level=level + 1); its live rows equal the single-card
        mod_switch_to_next chain's."""
        p = self.params
        if p.r - 1 - level < 3:
            raise ValueError("modulus chain exhausted: need >= 3 live "
                             f"ciphertext moduli, have {p.r - 1 - level}")
        ct = self._local("ct", ct, (len(ct), p.r, p.n), 1,
                         "SPMD ciphertexts use the padded (L, r, n) "
                         "reference layout")
        last = p.r - 2 - level               # the global row being dropped
        half_mod, invq, qlast, half = self._switch_consts(level)
        ms = self.tables.ms
        rows = torch.arange(self.lo, self.hi, device=self.device)
        own = (rows == last)[:, None]
        ra = torch.where(own, ct, torch.zeros_like(ct)).sum(dim=-2)  # (L, n)
        mesh_mod.all_reduce(ra, self.group)
        ra = ra + half
        ra = ra - qlast * (ra >= qlast).to(I64)
        tmp = modmath.mod_u64(ra[:, None, :], ms.q, ms.nu)
        tmp = tmp + ms.q * (tmp < half_mod).to(I64) - half_mod
        v = ct + ms.q * (ct < tmp).to(I64) - tmp
        return self._dtensor(modmath.mont_mul(v, invq, ms.q, ms.qinv_neg), 1)

    def _switch_consts(self, level: int):
        """The rank's rows of _mod_switch_consts_padded as (rl, 1) columns
        on the device, with q_last and half (cached)."""
        key = ("switch", level)
        sc = self._cache.get(key)
        if sc is None:
            hmod, invq, qlast, half = _mod_switch_consts_padded(self.params,
                                                                level)
            sl = slice(self.lo, self.hi)
            sc = (modmath.const(hmod[sl], self.device),
                  modmath.const(invq[sl], self.device), qlast, half)
            self._cache[key] = sc
        return sc


@functools.lru_cache(maxsize=None)
def _chain_params(params: BFVParams, level: int) -> BFVParams:
    """The params `level` steps down the modulus chain (as
    BFVContext.next_context's)."""
    if level == 0:
        return params
    w = params.r - level
    if w < 2:
        raise ValueError(f"level {level} exhausts the {params.r}-modulus "
                         "chain")
    return BFVParams(name=f"{params.name}@L{w}", n=params.n, q=params.q[:w],
                     psi=params.psi[:w], t=params.t, gamma=params.gamma)


@functools.lru_cache(maxsize=None)
def _mod_switch_consts_padded(params: BFVParams, level: int):
    """The modulus drop at `level` over all r rows: (half_mod (r,),
    inv_q_last in Montgomery form (r,), q_last, half), as Python ints.
    Padded row r - 1 is the never-dropped special slot; the level's last
    live ciphertext residue is row r - 2 - level; rows at or beyond it get
    identity roles (half_mod 0, inverse 1): their outputs are padding."""
    last = params.r - 2 - level
    qlast = params.q[last]
    half = qlast >> 1
    hmod, invq = [], []
    for i, q in enumerate(params.q):
        live = i < last
        hmod.append(half % q if live else 0)
        invq.append(hm.to_mont(pow(qlast, -1, q) if live else 1, q))
    return tuple(hmod), tuple(invq), qlast, half
