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
    """Reject user nonces with bit 63 set.  That bit is reserved for the
    keygen/encrypt domain separation: two raw nonces differing only in
    bit 63 would map to the same effective stream, and keygen(2**63) would
    reproduce the nonce-0 secret key."""
    v = np.asarray(nonce, dtype=np.uint64)
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
    (bfv_encryption.cuh:247): ternary bytes at 0, e0 at n, e1 at 5n."""
    nbytes = encrypt_entropy_bytes(n)
    bw = salsa20.keystream_block_words((nbytes + 63) // 64, key_byte=key_byte,
                                       nonce=encrypt_nonce(nonce),
                                       device=device)
    u_b = ternary_int(salsa20.block_words_u8(bw, 0, n))
    e_d = torch.stack([gaussian_int(salsa20.block_words_u32(bw, n, n)),
                       gaussian_int(salsa20.block_words_u32(bw, 5 * n, n))])
    return u_b, e_d
