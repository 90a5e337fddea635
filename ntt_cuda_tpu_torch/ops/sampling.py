"""Distribution converters: keystream -> ternary / uniform / Gaussian draws.

Counterpart of `ntt_cuda_tpu/ops/sampling.py` (the reference's samplers,
bfv_keygen.cuh:14-79 and bfv_encryption.cuh:17-109), with the same
documented spec choices: the integer-exact uniform floor(u * (q-1) / 2^64),
the pinned 38-threshold Gaussian, the exact ternary with its byte-255 -> 2
quirk, and bit-63 nonce domain separation between keygen and encryption.
The converters are plain tensor code on the keystream's device, as they
are XLA outside any kernel in the JAX package.  Only the `uniform_spec=
"int"` spec is here; the fp64 emulation is not ported yet.

Draws come in COMPACT form: the ternary and Gaussian values are one int32
plane shared by every modulus, and the kernels map a negative value d to
q + d themselves (`small_res` is that map, the JAX package's
`ternary_res` / `gauss_res`, for the plain versions).
"""

from __future__ import annotations

import numpy as np
import torch

from . import modmath, salsa20
from .modmath import I64

_NONCE_HIGH_BIT = 1 << 63


def check_user_nonce(nonce) -> None:
    """Reject user nonces with bit 63 set (one nonce or a (J,) batch).
    That bit is reserved for the keygen/encrypt domain separation: two raw
    nonces differing only in bit 63 would map to the same effective stream,
    and keygen(2**63) would reproduce the nonce-0 secret key."""
    v = salsa20.nonce_array(nonce)
    if np.any(v >> np.uint64(63)):
        raise ValueError(
            "nonce bit 63 is reserved for keygen/encrypt domain "
            "separation; user nonces must be < 2**63")


def keygen_nonce(nonce: int) -> int:
    """Keygen's effective Salsa20 nonce: bit 63 cleared (0 maps to 0)."""
    return int(nonce) & (_NONCE_HIGH_BIT - 1)


def encrypt_nonce(nonce: int) -> int:
    """Encryption's effective Salsa20 nonce: bit 63 set on every nonzero
    nonce; 0 passes through (the reference's fixed-randomness pipeline,
    which shares the keygen stream by design)."""
    nonce = int(nonce)
    return nonce if nonce == 0 else nonce | _NONCE_HIGH_BIT


def encrypt_nonces(nonces) -> np.ndarray:
    """encrypt_nonce of each of (J,) nonces, as one uint64 array."""
    v = salsa20.nonce_array(nonces)
    return np.where(v == 0, v, v | np.uint64(_NONCE_HIGH_BIT))


def ternary_int(bytes_u8: torch.Tensor) -> torch.Tensor:
    """(..., n) bytes -> (..., n) int32 ternary values in {-1, 0, 1, 2}
    (b = int(byte / 85.0f) - 1, byte 255 -> 2 included)."""
    return (torch.div(bytes_u8, 85, rounding_mode="floor") - 1).to(torch.int32)


# The pinned Gaussian spec (ntt_cuda_tpu/ops/sampling.py GAUSS_ICDF_BOUNDS):
# for u in [1, 2^32-129], d(u) = -19 + #{b : u >= b}; u == 0 -> -16 and
# u >= 2^32 - 128 -> +16.
GAUSS_ICDF_BOUNDS = (
    7, 40, 233, 1232,
    5940, 26078, 104261, 379750,
    1260811, 3818335, 10556606, 26670310,
    61645758, 130551381, 253768664, 453762321,
    748401120, 1142399168, 1620621248, 2674346113,
    3152568192, 3546566273, 3841204865, 4041198721,
    4164415872, 4233321601, 4268297088, 4284410752,
    4291148929, 4293706369, 4294587521, 4294862977,
    4294941313, 4294961281, 4294966144, 4294967168,
    4294967168, 4294967168,
)


def gaussian_int(u32s: torch.Tensor) -> torch.Tensor:
    """(..., n) u32 words (int64 values) -> (..., n) int32 discrete-Gaussian
    values in [-19, 16] under the pinned threshold spec: 38 compares."""
    b = torch.tensor(GAUSS_ICDF_BOUNDS, dtype=I64, device=u32s.device)
    d = (u32s[..., None] >= b).sum(dim=-1) - 19
    d = torch.where(u32s == 0, -16, d)
    d = torch.where(u32s >= 2 ** 32 - 128, 16, d)
    return d.to(torch.int32)


def uniform(u64s: torch.Tensor, ms: modmath.ModulusSet) -> torch.Tensor:
    """(r, n) u64 lanes -> (r, n) uniform residues floor(u * (q-1) / 2^64)
    (the integer-exact spec)."""
    return modmath.mulhi_u64(u64s, ms.q - 1)


def small_res(d: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Compact ternary or Gaussian plane (..., n) -> per-modulus residues
    (..., r, n) with q (r, 1): negatives map to q + d, the rest broadcast
    unchanged (ternary_dist_xq / gaussian_dist_xq)."""
    d64 = d.to(I64)[..., None, :]
    return torch.where(d64 < 0, q + d64, d64.expand(
        d64.shape[:-2] + (q.shape[0], d64.shape[-1])))


def keygen_entropy_bytes(n: int, r: int) -> int:
    """generate_random_default size in keygen_rns (bfv_keygen.cuh:99)."""
    return 9 * r * n + 4 * n


def encrypt_entropy_bytes(n: int) -> int:
    """generate_random_default size in encryption_rns (bfv_encryption.cuh:228)."""
    return 9 * n


def keygen_draws_compact(n: int, r: int, ms: modmath.ModulusSet,
                         key_byte: int = salsa20.DEFAULT_KEY_BYTE, nonce=0):
    """Keygen draws on ms's device: (s_b (n,) int32, a (r, n) uniform
    residues, e_d (n,) int32).  Byte layout (bfv_keygen.cuh:120-122):
    ternary bytes at 0, uniform u64 lanes at n, Gaussian u32 at n + 8rn."""
    nbytes = keygen_entropy_bytes(n, r)
    bw, lanes = salsa20.keystream_block_words(
        (nbytes + 63) // 64, key_byte=key_byte, nonce=keygen_nonce(nonce),
        with_u64=True, device=ms.q.device)
    s_b = ternary_int(salsa20.block_words_u8(bw, 0, n))
    a = uniform(salsa20.block_words_u64_planes(lanes, n, r * n)
                .reshape(r, n), ms)
    e_d = gaussian_int(salsa20.block_words_u32(bw, n + 8 * r * n, n))
    return s_b, a, e_d


def encrypt_draws_compact(n: int, key_byte: int = salsa20.DEFAULT_KEY_BYTE,
                          nonce=0, device=None):
    """Encryption draws: (u_b (n,) int32, e_d (2, n) int32).  Layout
    (bfv_encryption.cuh:247): ternary bytes at 0, e0 at n, e1 at 5n.
    `device` None is the current CUDA device."""
    nbytes = encrypt_entropy_bytes(n)
    bw = salsa20.keystream_block_words((nbytes + 63) // 64, key_byte=key_byte,
                                       nonce=encrypt_nonce(nonce),
                                       device=device)
    u_b = ternary_int(salsa20.block_words_u8(bw, 0, n))
    e_d = torch.stack([gaussian_int(salsa20.block_words_u32(bw, n, n)),
                       gaussian_int(salsa20.block_words_u32(bw, 5 * n, n))])
    return u_b, e_d


def encrypt_draws_compact_batch(n: int, nonces,
                                key_byte: int = salsa20.DEFAULT_KEY_BYTE,
                                device=None):
    """Batched compact encryption draws: (J,) nonces -> (u_b (J, n) int32,
    e_d (J, 2, n) int32), row j equal to encrypt_draws_compact(n,
    nonce=nonces[j]).  One keystream launch (kernel 6) for the J mapped
    nonces, and every slice taken for all J rows at once.  `device` None
    is the current CUDA device."""
    nbytes = encrypt_entropy_bytes(n)
    bw = salsa20.keystream_block_words_batch(
        (nbytes + 63) // 64, encrypt_nonces(nonces), key_byte=key_byte,
        device=device)
    u_b = ternary_int(salsa20.block_words_u8_batch(bw, 0, n))
    e_d = gaussian_int(torch.stack(
        [salsa20.block_words_u32_batch(bw, n, n),
         salsa20.block_words_u32_batch(bw, 5 * n, n)], dim=1))
    return u_b, e_d


def encrypt_draws_batch(n: int, r: int, ms: modmath.ModulusSet, nonces,
                        key_byte: int = salsa20.DEFAULT_KEY_BYTE):
    """Batched encryption draws as residues on ms's device: (J,) nonces ->
    (u (J, r, n), e (J, 2, r, n)), the plain counterpart of the JAX
    package's encrypt_draws_batch."""
    if ms.r != r:
        raise ValueError(f"ms has {ms.r} moduli, expected r={r}")
    u_b, e_d = encrypt_draws_compact_batch(n, nonces, key_byte=key_byte,
                                           device=ms.q.device)
    return small_res(u_b, ms.q), small_res(e_d, ms.q)


# Relinearization-key draws: their own Salsa20 key byte (0x02), so every
# relin stream is independent of every keygen/encrypt stream at any nonce;
# the nonce takes the keygen half of the nonce space (bit 63 clear).
RELIN_KEY_BYTE = 0x02


def relin_entropy_bytes(n: int, r: int, k: int) -> int:
    """Per key: 8*r*n uniform bytes, then 4*n Gaussian bytes."""
    return k * (8 * r * n + 4 * n)


def relin_draws(n: int, r: int, k: int, ms: modmath.ModulusSet, nonce=0):
    """Draws of the k relinearization keys on ms's device: (a (k, r, n)
    uniform NTT-domain residues, e (k, r, n) Gaussian residues).  Key j
    owns the stream's bytes from j*(8rn + 4n): its r*n u64 lanes, then its
    n Gaussian words.  One keystream launch, and the k keys sliced out
    together (block-aligned: n >= 16)."""
    nbytes = relin_entropy_bytes(n, r, k)
    bw, lanes = salsa20.keystream_block_words(
        (nbytes + 63) // 64, key_byte=RELIN_KEY_BYTE,
        nonce=keygen_nonce(nonce), with_u64=True, device=ms.q.device)
    return _key_draws(bw, lanes, n, r, k, ms)


def _key_draws(bw, lanes, n: int, r: int, k: int, ms: modmath.ModulusSet):
    """The k switching keys' (a, e) from one stream whose key j owns the
    bytes from j*(8rn + 4n)."""
    kb = (8 * r * n + 4 * n) // 64       # blocks per key
    ub = 8 * r * n // 64                 # of them, the uniform lanes'
    u = (lanes[:, :k * kb].reshape(8, k, kb)[:, :, :ub]
         .permute(1, 2, 0).reshape(k, r, n))
    w = (bw[:, :k * kb].reshape(16, k, kb)[:, :, ub:ub + n // 16]
         .permute(1, 2, 0).reshape(k, n))
    return uniform(u, ms), small_res(gaussian_int(w), ms.q)


# Galois-key draws: their own key byte (0x03), independent of the keygen /
# encrypt (0x01) and relin (0x02) streams at any nonce.
GALOIS_KEY_BYTE = 0x03


def galois_draws(n: int, r: int, k: int, elts, ms: modmath.ModulusSet,
                 nonce=0):
    """Draws of the Galois switching keys of `elts` on ms's device:
    (a (E, k, r, n), e (E, k, r, n)), one keystream launch per element.

    The stream region is indexed by the ELEMENT VALUE, not its rank in the
    call (the JAX package's layout, ntt_cuda_tpu/ops/sampling.py:527-558):
    element g's k keys start at block counter g * ceil(k (8rn + 4n) / 64),
    laid out as relin_draws' keys.  Two calls at one nonce therefore give a
    shared element the same key, and distinct elements never share
    randomness."""
    region = (relin_entropy_bytes(n, r, k) + 63) // 64   # blocks per element
    a_rows, e_rows = [], []
    for g in elts:
        bw, lanes = salsa20.keystream_block_words(
            region, key_byte=GALOIS_KEY_BYTE, nonce=keygen_nonce(nonce),
            counter0=int(g) * region, with_u64=True, device=ms.q.device)
        a, e = _key_draws(bw, lanes, n, r, k, ms)
        a_rows.append(a)
        e_rows.append(e)
    return torch.stack(a_rows), torch.stack(e_rows)
