"""BFV keygen / encryption / decryption and the EvalMult evaluator (RNS
form, SEAL 3.5 semantics).

Counterpart of `ntt_cuda_tpu/models/bfv.py` (the reference's
bfv_keygen.cuh:95, bfv_encryption.cuh:223, bfv_decryption.cuh:76) with
both uniform specs of keygen (`uniform_spec="int"`, the integer-exact
default, and `"fp64"`, the reference's double-precision draw emulated
exactly: ops/sampling.uniform_ref), on the JAX package's two kernel
schedules:

* "op": one whole-op kernel per operation (ops/fused_ops.py; one
  thread-block cluster launch per polynomial at every n);
* "stage": one kernel per transform with its elementwise neighbours fused
  in (ops/ntt_stage.py, bfv_tail.encrypt_fused).

`fusion="auto"` picks as the JAX package does: "op" up to n = 16384,
"stage" above.  `encrypt_batch` runs the J-nonce keystream (kernel 6) and
the whole-op encrypt kernel under either schedule, as the JAX package
does.  The evaluator (mul, square, relin_keygen, relinearize, decrypt
of L >= 3 ciphertexts, and the Galois automorphisms galois_keygen,
apply_galois, rotate_rows and rotate_columns) ignores `fusion`, as the JAX
package's pallas backends do: its transforms are the stage kernels at
every n, its base conversions ops/behz_kernels.py and its key switch
fused_ops.keyswitch_fused.  The ciphertext ops (add, sub, negate,
add_plain, sub_plain, mod_switch_to_next) are plain tensor ops on the
device, as the JAX package leaves them to XLA; mul_plain runs the stage
transforms.  Eager PyTorch: each operation is a few kernel launches on
the context's device (the CPU runs the kernels' plain versions instead).

`op_programs()` and `mult_program()` give the ops as functions of their
tensors and a bundle of the context's constants, as the JAX package gives
them for an outer jit: with a nonce that lives on the card (an int64
tensor), no validation, no host read and nothing built at first use, so a
CUDA graph can capture them (`utils/profiling.graphed`) and replay them
with no host between the kernels.  The public methods run the same bodies
after validating their arguments.

Conventions are the JAX package's: sk (r, n) and pk (2, r, n) live in the
NTT domain; ciphertexts are (2, r-1, n) coefficient-domain residues with
the last modulus dropped; batches put J first.  Every u64 is carried in an
int64 tensor (all values are below 2^62).  Randomness is the Salsa20
stream, a deterministic function of the nonce.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import convert, cuda
from .. import params as params_mod
from ..cuda import BLOCK_MAX_N, TRANSFORM_MAX_N
from ..ops import (behz, behz_kernels, bfv_tail, fused_ops, modmath, ntt,
                   ntt_stage, poly, salsa20, sampling)
from ..ops.modmath import I64
from ..utils import hostmath as hm
from . import encoder

def _as_tensor(name: str, x) -> torch.Tensor:
    """Tensor view of an array argument, keeping u64 bit patterns exact."""
    if isinstance(x, torch.Tensor):
        return x.view(I64) if x.dtype == torch.uint64 else x
    try:
        a = np.asarray(x)
    except (TypeError, ValueError) as e:
        raise TypeError(f"{name}: expected an array, got "
                        f"{type(x).__name__} ({e})") from None
    if a.dtype.kind not in "iub" and a.dtype.kind != "f":
        raise TypeError(f"{name}: expected an array, got "
                        f"{type(x).__name__} (dtype {a.dtype})")
    if a.dtype == np.uint64:
        a = a.view(np.int64)
    elif a.dtype.kind in "iu":
        a = a.astype(np.int64)
    return torch.tensor(a)     # a copy: the array may be read-only


def check_residues(name: str, x, shape: tuple, hint: str = "",
                   device=None) -> torch.Tensor:
    """Validate a residue-tensor argument at the public API boundary:
    exact shape and an integer dtype, returned as a contiguous int64
    tensor on `device`.  Raises at once with an actionable message."""
    x = _as_tensor(name, x)
    if x.dtype.is_floating_point or x.dtype.is_complex or x.dtype == torch.bool:
        raise TypeError(f"{name}: expected an integer array (canonically "
                        f"uint64), got dtype {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        msg = f"{name}: expected shape {tuple(shape)}, got {tuple(x.shape)}"
        if hint:
            msg += f" — {hint}"
        raise ValueError(msg)
    return x.to(device=device, dtype=I64).contiguous()


# -- the ops' bodies: shared by the public methods (after validation) and the
# programs (none); a nonce is an int or an int64 tensor on the device ------

def _keygen(nonce, tf: ntt.NTTTables, fusion: str, uniform_spec: str):
    """-> (sk (r, n), pk (2, r, n)), both NTT domain."""
    s_b, a, e_d = sampling.keygen_draws_compact(tf.n, tf.r, tf.ms,
                                                nonce=nonce,
                                                uniform_spec=uniform_spec)
    if fusion == "op":
        sk, pk0 = fused_ops.keygen_fused(s_b, a, e_d, tf)
    else:
        sk = ntt_stage.ntt_forward_ternary(s_b, tf)
        pk0 = ntt_stage.ntt_inverse_mul(a, sk, tf)
        pk0 = ntt_stage.ntt_forward_addneg_gauss(pk0, e_d, tf)
    return sk, torch.stack([pk0, a])


def _encrypt(nonce, pk, m_poly, tf: ntt.NTTTables,
             tc: bfv_tail.TailConsts, fusion: str):
    """pk (2, r, n), m_poly (n,) -> the (2, r-1, n) ciphertext."""
    u_b, e_d = sampling.encrypt_draws_compact(tf.n, nonce=nonce,
                                              device=tf.device)
    if fusion == "op":
        return fused_ops.encrypt_fused(u_b, pk, e_d, m_poly, tf, tc)
    u_ntt = ntt_stage.ntt_forward_ternary(u_b, tf)
    return bfv_tail.encrypt_fused(u_ntt, pk, e_d, m_poly, tf, tc)


def _encrypt_batch(nonces, pk, m_batch, tf: ntt.NTTTables,
                   tc: bfv_tail.TailConsts):
    """(J,) nonces, m_batch (J, n) -> (J, 2, r-1, n): kernel 6, then the
    whole-op encrypt over the batch whatever the fusion."""
    u_b, e_d = sampling.encrypt_draws_compact_batch(tf.n, nonces,
                                                    device=tf.device)
    return fused_ops.encrypt_fused(u_b, pk, e_d, m_batch, tf, tc)


def _front(c1, sk_drop, td: ntt.NTTTables, fusion: str):
    """Decryption's front half, INTT(NTT(c1) (.) sk): (..., r-1, n)."""
    if fusion == "op":
        return fused_ops.half_polymul(c1, sk_drop, td)
    return ntt_stage.ntt_inverse_mul(ntt_stage.ntt_forward(c1, td), sk_drop,
                                     td)


def _decrypt(sk_drop, ct, td: ntt.NTTTables, dtc: bfv_tail.DecTailConsts,
             fusion: str):
    """L = 2: ct (2, r-1, n) -> (n,), or cts (J, 2, r-1, n) -> (J, n)."""
    c0 = ct[..., 0, :, :].contiguous()
    c1 = ct[..., 1, :, :].contiguous()
    return bfv_tail.decrypt_tail(_front(c1, sk_drop, td, fusion), c0, dtc)


def _mul(x, banks: behz_kernels.MultBanks, tq: ntt.NTTTables,
         tb: ntt.NTTTables, square: bool = False):
    """The BEHZ product of x (..., 2, 2, k, n) (operand, component; one
    operand, (..., 1, 2, k, n), for `square`) -> (..., 3, k, n): both
    operands to Bsk together (21a), the transforms over q and Bsk, the
    tensor product, t/q back into q (21b, 21c)."""
    fq = BFVContext._fwd_rows(x, tq)
    fb = BFVContext._fwd_rows(behz_kernels.rns_to_bsk(x, banks), tb)
    return behz_kernels.scale_and_round(BFVContext._tensor(fq, tq, square),
                                        BFVContext._tensor(fb, tb, square),
                                        banks)


def _relinearize(ct3, rlk, tf: ntt.NTTTables, tc: bfv_tail.TailConsts,
                 q_drop: torch.Tensor):
    """Key-switch c2 of ct3 (..., 3, r-1, n) through rlk and add it to
    (c0, c1) exactly (not the strict-`>` quirk: outputs stay canonical)."""
    cc = fused_ops.keyswitch_fused(ct3[..., 2, :, :].contiguous(), rlk, tf,
                                   tc)
    return modmath.add_mod(ct3[..., :2, :, :], cc, q_drop)


@dataclasses.dataclass(frozen=True)
class _MultSetup:
    """EvalMult state of one context, built at its first use: the aux base
    Bsk, the conversion kernels' banks (with the plain MultConsts) and the
    NTT tables over Bsk."""

    aux: behz.AuxBase
    banks: behz_kernels.MultBanks
    tables_bsk: ntt.NTTTables          # (k+1, n)


@dataclasses.dataclass(frozen=True)
class BFVContext:
    """Device-resident constants for one parameter set (the analog of
    demo.cu's host precompute + cudaMemcpyToSymbol setup, demo.cu:62-272).
    Build once per set and device with `BFVContext.build`."""

    params: params_mod.BFVParams
    device: torch.device
    fusion: str                        # "op" or "stage"
    uniform_spec: str                  # "int" or "fp64" (keygen's draw)
    tables_full: ntt.NTTTables         # (r, n)
    tables_drop: ntt.NTTTables         # (r-1, n)
    tail_consts: bfv_tail.TailConsts
    dec_tail_consts: bfv_tail.DecTailConsts
    # lazily built EvalMult state; a mutable cache on a frozen context,
    # left out of eq/hash
    _mult_cache: dict = dataclasses.field(default_factory=dict,
                                          compare=False, repr=False)

    @staticmethod
    def build(params: params_mod.BFVParams, device=None,
              uniform_spec: str = "int", fusion: str = "auto") -> "BFVContext":
        """Precompute and upload every constant the ops need.

        `device` None is the current CUDA device; where there is none this
        raises, and `device="cpu"` runs the kernels' plain versions.
        fusion "auto" is the JAX package's rule: "op" for n <= 16384,
        "stage" above.  uniform_spec "fp64" makes keygen's uniform draw the
        reference's exact double-precision one (sampling.uniform_ref).  t
        is a power of two or odd below 2^62 (the decrypt kernels pick
        their mod-t strategy by t, bfv_tail._t_strategy); n a power of two
        up to 131072.  Nothing falls back."""
        if params.t % 2 == 0 and params.t & (params.t - 1):
            raise ValueError(
                f"t={params.t} is neither a power of two (reference "
                f"semantics) nor odd (batching-prime semantics); no "
                f"decrypt path supports it")
        if params.t & (params.t - 1) and params.t >= bfv_tail.T_MAX:
            raise ValueError(
                f"t={params.t} >= 2^62: no modulus below 2^62 is 1 mod t, "
                f"as encryption's Delta embedding assumes")
        if uniform_spec not in ("int", "fp64"):
            raise ValueError(f"unknown uniform_spec {uniform_spec!r}")
        if fusion == "auto":
            fusion = "op" if params.n <= BLOCK_MAX_N else "stage"
        if fusion not in ("op", "stage"):
            raise ValueError(f"unknown fusion {fusion!r}")
        if params.n > TRANSFORM_MAX_N:
            raise NotImplementedError(
                f"n={params.n} > {TRANSFORM_MAX_N}: no transform kernel "
                f"takes it")
        device = cuda.default_device(device, "BFVContext.build")
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        return BFVContext(
            params=params,
            device=device,
            fusion=fusion,
            uniform_spec=uniform_spec,
            tables_full=ntt.tables_for(params, device=device),
            tables_drop=ntt.tables_for(params, params.r - 1, device=device),
            tail_consts=bfv_tail.TailConsts.build(params, device),
            dec_tail_consts=bfv_tail.DecTailConsts.build(params, device),
        )

    # -- public API ---------------------------------------------------------

    def keygen(self, nonce=0):
        """-> (sk (r, n), pk (2, r, n)), both NTT domain (keygen_rns,
        bfv_keygen.cuh:95-151).  Keygen nonces live in the bit-63-clear
        half of the nonce space; nonces must be < 2**63."""
        sampling.check_user_nonce(nonce)
        return _keygen(int(nonce), self.tables_full, self.fusion,
                       self.uniform_spec)

    def encrypt(self, pk, m_poly, nonce=0):
        """pk (2, r, n) NTT domain, m_poly (n,) in [0, t) -> ciphertext
        (2, r-1, n), coefficient domain (encryption_rns,
        bfv_encryption.cuh:223-290).  Pass a distinct nonce per message;
        nonzero nonces are mapped into the bit-63-set half of the nonce
        space, nonce 0 is the reference's fixed-randomness pipeline.
        Nonces must be < 2**63."""
        sampling.check_user_nonce(nonce)
        p = self.params
        pk = check_residues("pk", pk, (2, p.r, p.n),
                            "keygen returns the NTT-domain (2, r, n) pk",
                            self.device)
        m_poly = check_residues("m_poly", m_poly, (p.n,),
                                f"one plaintext value in [0, t) per "
                                f"coefficient, n={p.n}", self.device)
        return _encrypt(int(nonce), pk, m_poly, self.tables_full,
                        self.tail_consts, self.fusion)

    def encrypt_batch(self, pk, m_batch, nonces):
        """Throughput-mode encryption: pk (2, r, n) NTT domain, m_batch
        (J, n) in [0, t), nonces (J,) distinct per message -> (J, 2, r-1,
        n) ciphertexts, row j bit-identical to encrypt(pk, m_batch[j],
        nonces[j]).  One keystream launch for the J nonces (kernel 6) and
        the whole-op encrypt kernel over the batch, whatever the context's
        fusion (the JAX package's rule, ntt_cuda_tpu/models/bfv.py:988-999).
        The kernel's (J, 2, r, n) scratch is J 2 r n 8 bytes: 75 MB at
        32k_9q, J = 16.  The JAX package splits larger batches for the
        TPU's VMEM; the split changes no integer, so the port does not."""
        p = self.params
        pk = check_residues("pk", pk, (2, p.r, p.n),
                            "keygen returns the NTT-domain (2, r, n) pk",
                            self.device)
        m_batch = _as_tensor("m_batch", m_batch)
        if m_batch.dim() != 2:
            raise ValueError(f"m_batch: expected (J, n), got "
                             f"{tuple(m_batch.shape)}")
        J = m_batch.shape[0]
        m_batch = check_residues("m_batch", m_batch, (J, p.n),
                                 device=self.device)
        sampling.check_user_nonce(nonces)
        nonces = salsa20.nonce_array(nonces)
        if nonces.shape != (J,):
            raise ValueError(f"nonces: expected shape ({J},), got "
                             f"{nonces.shape}")
        return _encrypt_batch(nonces, pk, m_batch, self.tables_full,
                              self.tail_consts)

    def decrypt(self, sk, ct):
        """sk (r, n) NTT domain (first r-1 residues used; (r-1, n) also
        accepted), ct (L, r-1, n) -> plaintext (n,) in [0, t)
        (decryption_rns, bfv_decryption.cuh:76-138).  L = 2 for fresh or
        relinearized ciphertexts; L >= 3 decrypts mul()'s output directly
        (c0 + c1 s + ... + c_{L-1} s^{L-1})."""
        sk = self._sk_drop(sk)
        ct = self._ct_any("ct", ct, "encrypt returns (2, r-1, n), mul() "
                          "(3, r-1, n) — the last RNS modulus is dropped")
        if ct.shape[0] == 2:
            return _decrypt(sk, ct, self.tables_drop, self.dec_tail_consts,
                            self.fusion)
        return bfv_tail.decrypt_tail(self._spower_front(ct[1:], sk), ct[0],
                                     self.dec_tail_consts)

    def decrypt_batch(self, sk, cts):
        """Throughput-mode decryption: cts (J, 2, r-1, n) -> (J, n), one
        launch per kernel for all J messages; equal to decrypt() per
        message."""
        p = self.params
        sk = self._sk_drop(sk)
        cts = _as_tensor("cts", cts)
        if cts.dim() != 4:
            raise ValueError(f"cts: expected (J, 2, r-1, n), got "
                             f"{tuple(cts.shape)}")
        J = cts.shape[0]
        cts = check_residues("cts", cts, (J, 2, p.r - 1, p.n),
                             device=self.device)
        return _decrypt(sk, cts, self.tables_drop, self.dec_tail_consts,
                        self.fusion)

    def add(self, ct_a, ct_b):
        """Homomorphic addition: decrypts to (m1 + m2) mod t.  (2, r-1, n)
        ciphertexts or (J, 2, r-1, n) batches of one shape.  The exact
        mod-q add (not the strict-`>` quirk): sums equal to q reduce to 0,
        so outputs stay canonical."""
        a, b = self._ct_pair("add", ct_a, ct_b)
        return modmath.add_mod(a, b, self.tables_drop.ms.q)

    def sub(self, ct_a, ct_b):
        """Homomorphic subtraction: decrypts to (m1 - m2) mod t; shapes as
        add()."""
        a, b = self._ct_pair("sub", ct_a, ct_b)
        return poly.poly_sub(a, b, self.tables_drop.ms)

    def add_plain(self, ct, m_poly):
        """Ciphertext (2, r-1, n) + plaintext (n,): decrypts to (m_ct + m)
        mod t.  Encryption's Delta-scaling (poly.add_message) on c0; no
        noise is added."""
        ct, m_poly = self._ct_plain(ct, m_poly)
        c0 = poly.add_message(ct[0], m_poly, self.tail_consts.msg)
        return torch.stack([c0, ct[1]])

    def sub_plain(self, ct, m_poly):
        """Ciphertext - plaintext: decrypts to (m_ct - m) mod t, the exact
        inverse of add_plain."""
        ct, m_poly = self._ct_plain(ct, m_poly)
        c0 = poly.sub_message(ct[0], m_poly, self.tail_consts.msg)
        return torch.stack([c0, ct[1]])

    def negate(self, ct):
        """Homomorphic negation: decrypts to (-m) mod t.  (2, r-1, n) or
        (J, 2, r-1, n); canonical 0 stays 0."""
        p = self.params
        ct = _as_tensor("ct", ct)
        if tuple(ct.shape[-3:]) != (2, p.r - 1, p.n) or ct.dim() not in (3, 4):
            raise ValueError(f"ct: expected (2, r-1, n) or (J, 2, r-1, n),"
                             f" got {tuple(ct.shape)}")
        ct = check_residues("ct", ct, tuple(ct.shape), device=self.device)
        return poly.poly_negate(ct, self.tables_drop.ms)

    def mul_plain(self, ct, m_poly):
        """Ciphertext (2, r-1, n) * plaintext (n,) in Z_t[x]/(x^n + 1):
        decrypts to the negacyclic product (m_ct * m) mod t.  Both
        components and m (its residues are m itself: m < t < q_i) go
        through one forward launch (kernel 7), then one INTT(c_i (.) m^)
        launch (kernel 8), at every n.  Noise grows with m: monomials and
        small constants are safe, dense plaintexts can exhaust a fresh
        ciphertext's budget."""
        ct, m_poly = self._ct_plain(ct, m_poly)
        td = self.tables_drop
        x = torch.cat([ct, m_poly.expand(1, td.r, td.n)])   # (3, r-1, n)
        f = ntt_stage.ntt_forward(x, td)
        return ntt_stage.ntt_inverse_mul(f[:2], f[2], td)

    def next_context(self) -> "BFVContext":
        """The context one level down the modulus chain: the same scheme
        over q[:-1], q[r-2] taking the dropped modulus's role, on the same
        device with the same fusion and uniform spec.  Cached.  Decryption
        there takes the same sk (its first r-2 rows)."""
        nxt = self._mult_cache.get("next_ctx")
        if nxt is None:
            p = self.params
            if p.r < 3:
                raise ValueError("modulus chain exhausted: r must be >= 3 "
                                 "to drop another modulus")
            np_ = params_mod.BFVParams(
                name=f"{p.name}@L{p.r - 1}", n=p.n, q=p.q[:-1],
                psi=p.psi[:-1], t=p.t, gamma=p.gamma)
            nxt = BFVContext.build(np_, device=self.device,
                                   uniform_spec=self.uniform_spec,
                                   fusion=self.fusion)
            self._mult_cache["next_ctx"] = nxt
        return nxt

    def mod_switch_to_next(self, ct):
        """Switch a ciphertext one level down the modulus chain (SEAL's
        mod_switch_to_next): (L, r-1, n) -> (L, r-2, n), each component
        divided and rounded by the last kept modulus, with encryption's
        modulus drop (bfv_encryption.cuh:111-178) under next_context()'s
        constants.  Decrypt it under next_context()."""
        ct = self._ct_any("ct", ct)
        tc = self.next_context().tail_consts
        return poly.divide_and_round_q_last(ct, tc.dr, tc.ms_drop, tc.ms_last)

    def noise_budget(self, sk, ct) -> int:
        """Invariant noise budget in bits (SEAL's invariant_noise_budget):
        floor(log2(q / (2 |w|))) with w = [t (c0 + c1 s + ...)]_q centered;
        0 means decryption is no longer guaranteed.  The residues of w come
        from the decrypt front on the device (the L >= 2 front, the
        strict-`>` add of c0, t in Montgomery form); the centered CRT and
        the max-norm run on the host in Python ints, as in the JAX
        package.  A diagnostic, not a hot-path op."""
        p = self.params
        sk = self._sk_drop(sk)
        ct = self._ct_any("ct", ct)
        ms = self.tables_drop.ms
        t_mont = self._mult_cache.get("t_mont_drop")
        if t_mont is None:
            t_mont = modmath.const([hm.to_mont(p.t % qj, qj)
                                    for qj in p.q[:-1]], self.device)
            self._mult_cache["t_mont_drop"] = t_mont
        x = poly.poly_add(self._spower_front(ct[1:], sk), ct[0], ms)
        w = convert.to_numpy(modmath.mont_mul(x, t_mont, ms.q,
                                              ms.qinv_neg)).tolist()
        qs = list(p.q[: p.r - 1])
        q_prod = 1
        for q in qs:
            q_prod *= q
        lifts = [(q_prod // q) * pow((q_prod // q) % q, -1, q) for q in qs]
        q_half = q_prod // 2
        max_w = 0
        for col in zip(*w):
            x = sum(v * lift for v, lift in zip(col, lifts)) % q_prod
            if x > q_half:
                x = q_prod - x
            if x > max_w:
                max_w = x
        if max_w == 0:
            return q_prod.bit_length() - 1
        return max(0, (q_prod // (2 * max_w)).bit_length() - 1)

    def mul(self, ct_a, ct_b, rlk=None):
        """Homomorphic multiplication (BEHZ RNS EvalMult): decrypts to the
        negacyclic product (m1 * m2) mod t.  (2, r-1, n) ciphertexts or
        (J, 2, r-1, n) batches -> (..., 3, r-1, n), or (..., 2, r-1, n)
        relinearized when `rlk` (relin_keygen) is given.

        Both operands extend to Bsk together (21a), are transformed over q
        and Bsk, multiplied out (the tensor product below), and scaled by
        t/q back into q (21b, 21c)."""
        a, b = self._ct_pair("mul", ct_a, ct_b)
        st = self._mult_setup()
        ct3 = _mul(torch.stack([a, b], dim=-4), st.banks, self.tables_drop,
                   st.tables_bsk)
        return ct3 if rlk is None else self.relinearize(ct3, rlk)

    def square(self, ct, rlk=None):
        """Homomorphic squaring: bit-identical to mul(ct, ct), with one
        operand's transforms and conversion."""
        a, _ = self._ct_pair("square", ct, ct)
        st = self._mult_setup()
        ct3 = _mul(a[..., None, :, :, :], st.banks, self.tables_drop,
                   st.tables_bsk, square=True)
        return ct3 if rlk is None else self.relinearize(ct3, rlk)

    def op_programs(self):
        """(kg_fn, enc_fn, dec_fn, enc_batch_fn, dec_batch_fn, bundles):
        the scheme ops as functions of their tensors and `bundles`, the
        context's constants (the JAX package's op_programs, same tuple and
        argument order):

            kg_fn(nonce, bz) == keygen(nonce)
            enc_fn(nonce, pk, m, bz) == encrypt(pk, m, nonce)
            dec_fn(sk, ct, bz) == decrypt(sk, ct)   (L = 2; sk (r, n) or
                                                     (r-1, n))
            enc_batch_fn(nonces, pk, m_batch, bz) == encrypt_batch(...)
            dec_batch_fn(sk, cts, bz) == decrypt_batch(sk, cts)

        bit for bit.  A nonce is an int64 tensor of u64 bit patterns on the
        context's device, () or (J,): the draws read it there (kernel 6)
        and map it there, so nothing of its value reaches the host, and a
        CUDA graph of a function replays it at whatever value the tensor
        holds.  No argument validation, as in the JAX package: callers hold
        validated tensors (int64, contiguous, on the device); a nonce is
        not checked against bit 63 (keygen clears it, encrypt sets it).
        Each function reads its constants from `bz` and allocates only its
        outputs and intermediates, so it can be captured
        (utils/profiling.graphed) after one warm-up call."""
        r, fusion, us = self.params.r, self.fusion, self.uniform_spec
        bundles = dict(tf=self.tables_full, td=self.tables_drop,
                       tc=self.tail_consts, dtc=self.dec_tail_consts)

        def kg_fn(nonce, bz):
            return _keygen(nonce, bz["tf"], fusion, us)

        def enc_fn(nonce, pk, m_poly, bz):
            return _encrypt(nonce, pk, m_poly, bz["tf"], bz["tc"], fusion)

        def dec_fn(sk, ct, bz):
            return _decrypt(sk[: r - 1], ct, bz["td"], bz["dtc"], fusion)

        def enc_batch_fn(nonces, pk, m_batch, bz):
            return _encrypt_batch(nonces, pk, m_batch, bz["tf"], bz["tc"])

        def dec_batch_fn(sk, cts, bz):
            return _decrypt(sk[: r - 1], cts, bz["td"], bz["dtc"], fusion)

        return kg_fn, enc_fn, dec_fn, enc_batch_fn, dec_batch_fn, bundles

    def mult_program(self):
        """(mul_fn, square_fn, bundles): EvalMult as functions of its
        tensors and `bundles` (the JAX package's mult_program):
        mul_fn(a, b, rlk, bz) == mul(a, b, rlk=rlk) and square_fn(a, rlk,
        bz) == square(a, rlk=rlk) bit for bit, rlk None for the
        (..., 3, r-1, n) product.  `bundles` holds the BEHZ banks, the
        tables over q and Bsk and the key switch's constants; the EvalMult
        state is built here, before any capture.  No validation, as
        op_programs'."""
        st = self._mult_setup()
        bundles = dict(mb=st.banks, tq=self.tables_drop, tb=st.tables_bsk,
                       tf=self.tables_full, tc=self.tail_consts)

        def finish(ct3, rlk, bz):
            if rlk is None:
                return ct3
            return _relinearize(ct3, rlk, bz["tf"], bz["tc"],
                                bz["tq"].ms.q)

        def mul_fn(a, b, rlk, bz):
            return finish(_mul(torch.stack([a, b], dim=-4), bz["mb"],
                               bz["tq"], bz["tb"]), rlk, bz)

        def square_fn(a, rlk, bz):
            return finish(_mul(a[..., None, :, :, :], bz["mb"], bz["tq"],
                               bz["tb"], square=True), rlk, bz)

        return mul_fn, square_fn, bundles

    def relin_keygen(self, sk, nonce=0):
        """Relinearization keys for mul(): (2, r-1, r, n), NTT domain.
        Key j encrypts P * q~_j * s^2 over the full base, P = q_last (the
        special modulus relinearize divides by): key0_j = NTT(-(a_j s +
        e_j)) + P s^2 at modulus row j, key1_j = a_j.  Draws under Salsa20
        key byte 0x02; nonces must be < 2**63."""
        sampling.check_user_nonce(nonce)
        p = self.params
        sk = check_residues("sk", sk, (p.r, p.n),
                            "keygen returns the NTT-domain (r, n) sk",
                            self.device)
        ms = self.tables_full.ms
        a, e = sampling.relin_draws(p.n, p.r, p.r - 1, ms, nonce=int(nonce))
        return self._kskeygen(a, e, sk, ntt.dyadic_mul(sk, sk, ms))

    def galois_keygen(self, sk, elts, nonce=0):
        """Switching keys for the Galois automorphisms x -> x^g: {g: (2,
        r-1, r, n)} for each g in `elts` (odd, 0 < g < 2n), NTT domain.
        Key j of element g encrypts P * q~_j * tau_g(s) as relin_keygen's
        encrypt s^2.  tau_g(s) is kernel 7's inverse of sk, the
        coefficient permutation, and kernel 7's forward, for all elements
        in one launch each way.  Draws run under Salsa20 key byte 0x03
        with each element's stream at a region indexed by its value, so a
        second call at the same nonce reproduces a shared element's key;
        nonces must be < 2**63."""
        sampling.check_user_nonce(nonce)
        p = self.params
        sk = check_residues("sk", sk, (p.r, p.n),
                            "keygen returns the NTT-domain (r, n) sk",
                            self.device)
        elts = sorted({int(g) for g in elts})
        maps = [self._galois_map(g) for g in elts]     # validates each g
        tf = self.tables_full
        a, e = sampling.galois_draws(p.n, p.r, p.r - 1, elts, tf.ms,
                                     nonce=int(nonce))
        s_coef = ntt_stage.ntt_inverse(sk, tf)
        ts = torch.stack([poly.galois_apply(s_coef, perm, neg, tf.ms)
                          for perm, neg in maps])        # (E, r, n)
        keys = self._kskeygen(a, e, sk, ntt_stage.ntt_forward(ts, tf))
        return {g: keys[i] for i, g in enumerate(elts)}

    def apply_galois(self, ct, g, gk):
        """Homomorphic automorphism: decrypts to tau_g(m), out[j] =
        +-m[(j g^-1 mod 2n) mod n] with the negacyclic sign, mod t.  `gk`
        is galois_keygen(...)[g].  (2, r-1, n) ciphertexts or (J, 2, r-1,
        n) batches: the permutation of both components, the key switch of
        the permuted c1 (kernel 19) and an exact mod-q add into c0."""
        p = self.params
        ct = _as_tensor("ct", ct)
        base = (2, p.r - 1, p.n)
        if tuple(ct.shape[-3:]) != base or ct.dim() not in (3, 4):
            raise ValueError(f"ct: expected (2, r-1, n) or (J, 2, r-1, n) "
                             f"= (..., {base}), got {tuple(ct.shape)}")
        ct = check_residues("ct", ct, tuple(ct.shape), device=self.device)
        gk = check_residues("gk", gk, (2, p.r - 1, p.r, p.n),
                            "pass one key from galois_keygen()", self.device)
        perm, neg = self._galois_map(int(g))
        ms = self.tables_drop.ms
        tc = poly.galois_apply(ct, perm, neg, ms)
        cc = fused_ops.keyswitch_fused(tc[..., 1, :, :].contiguous(), gk,
                                       self.tables_full, self.tail_consts)
        c0 = modmath.add_mod(tc[..., 0, :, :], cc[..., 0, :, :], ms.q)
        return torch.stack([c0, cc[..., 1, :, :]], dim=-3)

    def rotate_rows(self, ct, steps, gks):
        """Cyclic rotation of both batching rows by `steps` (SEAL
        rotate_rows; a prime batching t and models/encoder.BatchEncoder).
        `gks` is galois_keygen's dict and must hold
        encoder.rotation_element(n, steps)."""
        g = encoder.rotation_element(self.params.n, steps)
        if g not in gks:
            raise KeyError(
                f"gks lacks the rotation element {g} for steps={steps}; "
                f"generate with galois_keygen(sk, "
                f"[rotation_element(n, {steps})])")
        return self.apply_galois(ct, g, gks[g])

    def rotate_columns(self, ct, gks):
        """Swap the two batching rows (SEAL rotate_columns; Galois
        element 2n - 1)."""
        g = encoder.column_element(self.params.n)
        if g not in gks:
            raise KeyError(f"gks lacks the column element {g}; generate "
                           f"with galois_keygen(sk, [2*n - 1])")
        return self.apply_galois(ct, g, gks[g])

    def relinearize(self, ct3, rlk):
        """(3, r-1, n) or (J, 3, r-1, n) mul() output + relin keys ->
        (..., 2, r-1, n): key-switch c2 through rlk (the RNS digits of c2,
        divided by q_last at the end) and add it to (c0, c1) exactly."""
        p = self.params
        ct3 = _as_tensor("ct3", ct3)
        base = (3, p.r - 1, p.n)
        if tuple(ct3.shape[-3:]) != base or ct3.dim() not in (3, 4):
            raise ValueError(f"ct3: expected (3, r-1, n) or (J, 3, r-1, n),"
                             f" got {tuple(ct3.shape)}")
        ct3 = check_residues("ct3", ct3, tuple(ct3.shape), device=self.device)
        rlk = check_residues("rlk", rlk, (2, p.r - 1, p.r, p.n),
                             "relin_keygen returns (2, r-1, r, n)",
                             self.device)
        return _relinearize(ct3, rlk, self.tables_full, self.tail_consts,
                            self.tables_drop.ms.q)

    def roundtrip_check(self, m_poly):
        """demo.cu-style end-to-end: decrypt(encrypt(m)) (demo.cu:274-311)."""
        sk, pk = self.keygen()
        ct = self.encrypt(pk, m_poly)
        return self.decrypt(sk, ct)

    def _spower_front(self, cts, sk_drop):
        """Extended decryption's front, INTT(sum_{i>=1} NTT(c_i) (.) s^i)
        for cts = (c_1, ..., c_{L-1}), (L-1, r-1, n): one forward launch,
        one INTT(x (.) y) launch against the powers of s, and the sum of
        its L-1 rows (the INTT is linear, so this equals the JAX package's
        single INTT of the sum)."""
        td = self.tables_drop
        pw = [sk_drop]
        for _ in range(1, cts.shape[0]):
            pw.append(ntt.dyadic_mul(pw[-1], sk_drop, td.ms))
        x = ntt_stage.ntt_inverse_mul(ntt_stage.ntt_forward(cts, td),
                                      torch.stack(pw), td)
        acc = x[0]
        for i in range(1, x.shape[0]):
            acc = modmath.add_mod(acc, x[i], td.ms.q)
        return acc

    @staticmethod
    def _fwd_rows(x, tables: ntt.NTTTables):
        """The forward transform of every (r, n) block of x (..., r, n)."""
        r, n = x.shape[-2:]
        return ntt_stage.ntt_forward(x.reshape(-1, r, n).contiguous(),
                                     tables).reshape(x.shape)

    # (operand, component) of x then of y in each INTT(x (.) y) of the
    # tensor product: c0 = a0 b0, c2 = a1 b1, then the cross terms
    _MUL_PAIRS = ((0, 0, 1, 0), (0, 1, 1, 1), (0, 0, 1, 1), (0, 1, 1, 0))
    _SQUARE_PAIRS = ((0, 0, 0, 0), (0, 1, 0, 1), (0, 0, 0, 1))

    @staticmethod
    def _tensor(f, tables: ntt.NTTTables, square: bool = False):
        """The tensor product of NTT-domain operands f (..., 2, 2, r, n)
        (operand, component; one operand for `square`) in the coefficient
        domain, (..., 3, r, n): one INTT(x (.) y) launch over the pairs
        above, then c1 as the sum of the two cross terms (the INTT is
        linear: equal to INTT(a0 b1 + a1 b0)), twice a0 a1 for a square."""
        pairs = BFVContext._SQUARE_PAIRS if square else BFVContext._MUL_PAIRS
        pick = lambda o, c: f[..., o, c, :, :]
        xs = torch.stack([pick(o, c) for o, c, _, _ in pairs], dim=-3)
        ys = torch.stack([pick(o, c) for _, _, o, c in pairs], dim=-3)
        r, n = f.shape[-2:]
        out = ntt_stage.ntt_inverse_mul(
            xs.reshape(-1, r, n), ys.reshape(-1, r, n), tables,
        ).reshape(xs.shape)
        q = tables.ms.q
        c1 = modmath.add_mod(out[..., 2, :, :],
                             out[..., 2 if square else 3, :, :], q)
        return torch.stack([out[..., 0, :, :], c1, out[..., 1, :, :]],
                           dim=-3)

    def _kskeygen(self, a, e, sk, target_hat):
        """Switching keys encrypting NTT-domain targets under sk (the JAX
        package's _kskeygen_body): a, e (..., k, r, n) draws, target_hat
        (..., r, n) -> (..., 2, k, r, n).  key0_j = NTT(-(a_j s + e_j)) +
        P * target at modulus row j (P = q_last), key1_j = a_j: one
        INTT(a (.) sk) launch (kernel 8) and one NTT(-(x + e)) launch
        (kernel 11) over every key, then the P * target term as plain
        tensor ops, as the JAX package leaves it to XLA."""
        tf = self.tables_full
        ms, (k, r, n) = tf.ms, a.shape[-3:]
        x = ntt_stage.ntt_inverse_mul(a.reshape(-1, r, n), sk, tf)
        x = ntt_stage.ntt_forward_addneg(x, e.reshape(-1, r, n),
                                         tf).reshape(a.shape)
        term = modmath.mont_mul(target_hat, self._p_mont_bank(), ms.q,
                                ms.qinv_neg)
        j = torch.arange(k, device=self.device)
        x[..., j, j, :] = modmath.add_mod(x[..., j, j, :], term[..., :k, :],
                                          ms.q[:k])
        return torch.stack([x, a], dim=-4)

    def _galois_map(self, g: int):
        """tau_g's (perm, neg) as tensors on the device; cached."""
        key = ("galois", g)
        m = self._mult_cache.get(key)
        if m is None:
            perm, neg = poly.galois_maps(self.params.n, g)
            m = (torch.from_numpy(perm.astype(np.int64)).to(self.device),
                 torch.from_numpy(neg).to(self.device))
            self._mult_cache[key] = m
        return m

    def _p_mont_bank(self):
        """(r, 1) P * R mod q_i (P = q_last): the switching keys' P factor
        on each modulus row (the last is 0, P = 0 mod q_last); cached."""
        pm = self._mult_cache.get("p_mont")
        if pm is None:
            p = self.params
            pm = modmath.const([hm.to_mont(p.q[-1] % qj, qj)
                                for qj in p.q[:-1]] + [0], self.device)
            self._mult_cache["p_mont"] = pm
        return pm

    def _mult_setup(self) -> _MultSetup:
        st = self._mult_cache.get("setup")
        if st is None:
            p = self.params
            aux = behz.AuxBase.build(p)
            st = _MultSetup(
                aux=aux,
                banks=behz_kernels.MultBanks.build(p, aux, self.device),
                tables_bsk=ntt.NTTTables.build(aux.bsk, aux.bsk_psi, p.n,
                                               self.device))
            self._mult_cache["setup"] = st
        return st

    def _ct_pair(self, op, ct_a, ct_b):
        """Two ciphertexts of one shape, (2, r-1, n) or (J, 2, r-1, n), as
        int64 tensors on the device."""
        p = self.params
        ct_a, ct_b = _as_tensor(f"{op} lhs", ct_a), _as_tensor(f"{op} rhs",
                                                                 ct_b)
        if tuple(ct_a.shape) != tuple(ct_b.shape):
            raise ValueError(f"{op}: ciphertext shapes differ "
                             f"({tuple(ct_a.shape)} vs {tuple(ct_b.shape)})")
        base = (2, p.r - 1, p.n)
        if tuple(ct_a.shape[-3:]) != base or ct_a.dim() not in (3, 4):
            raise ValueError(f"{op}: expected (2, r-1, n) or (J, 2, r-1, n) "
                             f"= (..., {base}), got {tuple(ct_a.shape)}")
        return (check_residues(f"{op} lhs", ct_a, tuple(ct_a.shape),
                               device=self.device),
                check_residues(f"{op} rhs", ct_b, tuple(ct_b.shape),
                               device=self.device))

    def _ct_any(self, name: str, ct, hint: str = "") -> torch.Tensor:
        """An (L >= 2, r-1, n) ciphertext as an int64 tensor on the
        device."""
        p = self.params
        ct = _as_tensor(name, ct)
        if ct.dim() != 3 or ct.shape[0] < 2:
            raise ValueError(f"{name}: expected shape (L>=2, r-1, n), got "
                             f"{tuple(ct.shape)}")
        return check_residues(name, ct, (ct.shape[0], p.r - 1, p.n), hint,
                              self.device)

    def _ct_plain(self, ct, m_poly):
        """A (2, r-1, n) ciphertext and an (n,) plaintext on the device."""
        p = self.params
        ct = check_residues("ct", ct, (2, p.r - 1, p.n),
                            "encrypt returns (2, r-1, n)", self.device)
        m_poly = check_residues("m_poly", m_poly, (p.n,),
                                f"one plaintext value in [0, t) per "
                                f"coefficient, n={p.n}", self.device)
        return ct, m_poly

    def _sk_drop(self, sk):
        p = self.params
        sk = _as_tensor("sk", sk)
        if sk.dim() == 2 and sk.shape[0] >= p.r:
            # extra rows are the same s under higher-level moduli
            sk = sk[: p.r - 1]
        return check_residues("sk", sk, (p.r - 1, p.n),
                              "keygen returns the NTT-domain (r, n) sk",
                              self.device)
