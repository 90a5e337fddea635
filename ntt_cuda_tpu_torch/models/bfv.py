"""BFV keygen / encryption / decryption (RNS form, SEAL 3.5 semantics).

Counterpart of `ntt_cuda_tpu/models/bfv.py` (the reference's
bfv_keygen.cuh:95, bfv_encryption.cuh:223, bfv_decryption.cuh:76) for the
JAX package's default configuration at n <= 16384: the whole-op ("op")
schedule with the integer uniform spec.  Eager PyTorch: each operation is
a few kernel launches on the context's device (the CPU runs the kernels'
plain versions instead).

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

from .. import params as params_mod
from ..cuda import MAX_N
from ..ops import bfv_tail, fused_ops, ntt, sampling
from ..ops.modmath import I64

# What this slice leaves out, by the ROADMAP.md Queue 1 item that adds it.
_ROADMAP_STAGE = "ROADMAP.md Queue 1 item 1 (the stage schedule and n = 32768)"
_ROADMAP_FP64 = "ROADMAP.md Queue 1 item 3 (uniform_spec='fp64')"
_ROADMAP_EVAL = "ROADMAP.md Queue 1 item 5 (EvalMult)"


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


@dataclasses.dataclass(frozen=True)
class BFVContext:
    """Device-resident constants for one parameter set (the analog of
    demo.cu's host precompute + cudaMemcpyToSymbol setup, demo.cu:62-272).
    Build once per set and device with `BFVContext.build`."""

    params: params_mod.BFVParams
    device: torch.device
    tables_full: ntt.NTTTables         # (r, n)
    tables_drop: ntt.NTTTables         # (r-1, n)
    tail_consts: bfv_tail.TailConsts
    dec_tail_consts: bfv_tail.DecTailConsts

    @staticmethod
    def build(params: params_mod.BFVParams, device="cpu",
              uniform_spec: str = "int", fusion: str = "auto") -> "BFVContext":
        """Precompute and upload every constant the ops need.

        The slice runs the JAX package's default configuration for
        n <= 16384: fusion "auto" -> "op" (one kernel per op) and the
        integer uniform spec.  What is not ported raises
        NotImplementedError naming the ROADMAP item; nothing falls back."""
        if params.t % 2 == 0 and params.t & (params.t - 1):
            raise ValueError(
                f"t={params.t} is neither a power of two (reference "
                f"semantics) nor odd (batching-prime semantics); no "
                f"decrypt path supports it")
        if params.t & (params.t - 1) and params.t >= (1 << 31):
            raise ValueError(
                "the decrypt tail requires a power-of-two t or an odd "
                "t < 2^31")
        if uniform_spec not in ("int", "fp64"):
            raise ValueError(f"unknown uniform_spec {uniform_spec!r}")
        if fusion not in ("auto", "op", "stage"):
            raise ValueError(f"unknown fusion {fusion!r}")
        if params.n > MAX_N:
            raise NotImplementedError(
                f"n={params.n} > {MAX_N}: one polynomial no longer fits one "
                f"block's shared memory; see {_ROADMAP_STAGE}")
        if fusion == "stage":
            raise NotImplementedError(
                f"fusion='stage' is not ported; see {_ROADMAP_STAGE}")
        if uniform_spec == "fp64":
            raise NotImplementedError(
                f"uniform_spec='fp64' is not ported; see {_ROADMAP_FP64}")
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        return BFVContext(
            params=params,
            device=device,
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
        p = self.params
        s_b, a, e_d = sampling.keygen_draws_compact(
            p.n, p.r, self.tables_full.ms, nonce=int(nonce))
        sk, pk0 = fused_ops.keygen_fused(s_b, a, e_d, self.tables_full)
        return sk, torch.stack([pk0, a])

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
        u_b, e_d = sampling.encrypt_draws_compact(p.n, nonce=int(nonce),
                                                  device=self.device)
        return fused_ops.encrypt_fused(u_b, pk, e_d, m_poly, self.tables_full,
                                       self.tail_consts)

    def decrypt(self, sk, ct):
        """sk (r, n) NTT domain (first r-1 residues used; (r-1, n) also
        accepted), ct (2, r-1, n) -> plaintext (n,) in [0, t)
        (decryption_rns, bfv_decryption.cuh:76-138)."""
        p = self.params
        sk = self._sk_drop(sk)
        ct = _as_tensor("ct", ct)
        if ct.dim() != 3 or ct.shape[0] < 2:
            raise ValueError(f"ct: expected shape (L>=2, r-1, n), got "
                             f"{tuple(ct.shape)}")
        if ct.shape[0] > 2:
            raise NotImplementedError(
                f"decrypting an L={ct.shape[0]} (un-relinearized) "
                f"ciphertext is not ported; see {_ROADMAP_EVAL}")
        ct = check_residues("ct", ct, (2, p.r - 1, p.n),
                            "encrypt returns (2, r-1, n) — the last RNS "
                            "modulus is dropped", self.device)
        x = fused_ops.half_polymul(ct[1], sk, self.tables_drop)
        return bfv_tail.decrypt_tail(x, ct[0], self.dec_tail_consts)

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
        x = fused_ops.half_polymul(cts[:, 1].contiguous(), sk,
                                   self.tables_drop)
        return bfv_tail.decrypt_tail(x, cts[:, 0].contiguous(),
                                     self.dec_tail_consts)

    def roundtrip_check(self, m_poly):
        """demo.cu-style end-to-end: decrypt(encrypt(m)) (demo.cu:274-311)."""
        sk, pk = self.keygen()
        ct = self.encrypt(pk, m_poly)
        return self.decrypt(sk, ct)

    def _sk_drop(self, sk):
        p = self.params
        sk = _as_tensor("sk", sk)
        if sk.dim() == 2 and sk.shape[0] >= p.r:
            # extra rows are the same s under higher-level moduli
            sk = sk[: p.r - 1]
        return check_residues("sk", sk, (p.r - 1, p.n),
                              "keygen returns the NTT-domain (r, n) sk",
                              self.device)
