"""Distribution converters: keystream -> ternary / uniform / Gaussian draws.

Counterpart of `ntt_cuda_tpu/ops/sampling.py` (the reference's samplers,
bfv_keygen.cuh:14-79 and bfv_encryption.cuh:17-109), with the same
documented spec choices: the integer-exact uniform floor(u * (q-1) / 2^64),
the pinned 38-threshold Gaussian, the exact ternary with its byte-255 -> 2
quirk, and bit-63 nonce domain separation between keygen and encryption.
The converters are plain tensor code on the keystream's device, as they
are XLA outside any kernel in the JAX package, with one exception: on the
card, a batched encryption's draws (`encrypt_draws_compact_batch`) come
from one kernel that runs the streams and both converters
(`salsa20.encrypt_draws_batch`), and the plain path here is what it is
held to.  Both uniform specs are here: the integer-exact `uniform` (the
default, `uniform_spec="int"`) and `uniform_ref`, the reference's
IEEE-double data path emulated in integers (`uniform_spec="fp64"`,
keygen only, as in the JAX package).

A draw's nonce is a Python int, or an int64 tensor of u64 bit patterns on
the draws' device (`keygen_nonce_t` / `encrypt_nonce_t` map it there, and
`salsa20.keystream_words_batch` reads it there, with no host read), so that
`BFVContext.op_programs` can take a nonce that lives on the card and a CUDA
graph replays the draws at whatever value it holds.  A tensor nonce is not
checked (`check_user_nonce` reads the host), as the JAX package's programs
check none.

Draws come in COMPACT form: the ternary and Gaussian values are one int32
plane shared by every modulus, and the kernels map a negative value d to
q + d themselves (`small_res` is that map, the JAX package's
`ternary_res` / `gauss_res`, for the plain versions).  Every draw reads its
bytes, words or lanes as a view of the keystream (`salsa20.bytes_u8` /
`bytes_u32` / `bytes_u64`); only the converters write new tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import cuda
from ..utils import tracing
from . import modmath, salsa20
from .modmath import I64

_NONCE_HIGH_BIT = 1 << 63
_INT64_MIN = -_NONCE_HIGH_BIT       # bit 63 alone, as an int64


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


def keygen_nonce_t(nonce: torch.Tensor) -> torch.Tensor:
    """keygen_nonce of a () or (J,) int64 tensor of u64 bit patterns, on
    its device (the JAX package's keygen_nonce, a device op there too)."""
    return nonce & (_NONCE_HIGH_BIT - 1)


def encrypt_nonce_t(nonce: torch.Tensor) -> torch.Tensor:
    """encrypt_nonce of a () or (J,) int64 tensor of u64 bit patterns, on
    its device: bit 63 set where the nonce is not 0."""
    return torch.where(nonce == 0, nonce, nonce | _INT64_MIN)


def encrypt_nonces(nonces) -> np.ndarray:
    """encrypt_nonce of each of (J,) nonces, as one uint64 array."""
    v = salsa20.nonce_array(nonces)
    return np.where(v == 0, v, v | np.uint64(_NONCE_HIGH_BIT))


def ternary_int(bytes_u8: torch.Tensor) -> torch.Tensor:
    """(..., n) bytes (uint8, or any integer type) -> (..., n) int32
    ternary values in {-1, 0, 1, 2} (b = int(byte / 85.0f) - 1, byte 255
    -> 2 included).  Widened first: in uint8, byte // 85 - 1 would wrap
    to 255 for the bytes 0-84."""
    return torch.div(bytes_u8.to(torch.int32), 85, rounding_mode="floor") - 1


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


_GAUSS_BOUNDS: dict[torch.device, torch.Tensor] = {}


def _gauss_bounds(device: torch.device) -> torch.Tensor:
    """GAUSS_ICDF_BOUNDS as an int64 tensor on `device`, made at its first
    use there and kept: a copy from the host on every call would stop a
    CUDA graph from capturing the draws."""
    b = _GAUSS_BOUNDS.get(device)
    if b is None:
        b = _GAUSS_BOUNDS[device] = torch.tensor(GAUSS_ICDF_BOUNDS, dtype=I64,
                                                 device=device)
    return b


def gaussian_int(u32s: torch.Tensor) -> torch.Tensor:
    """(..., n) u32 words (int32 bit patterns, or int64 values) -> (..., n)
    int32 discrete-Gaussian values in [-19, 16] under the pinned threshold
    spec: 38 compares, on the words widened to int64 (a word >= 2^31 is
    negative as int32)."""
    u32s = u32s.to(I64) & salsa20.MASK32
    b = _gauss_bounds(u32s.device)
    d = (u32s[..., None] >= b).sum(dim=-1) - 19
    d = torch.where(u32s == 0, -16, d)
    d = torch.where(u32s >= 2 ** 32 - 128, 16, d)
    return d.to(torch.int32)


def uniform(u64s: torch.Tensor, ms: modmath.ModulusSet) -> torch.Tensor:
    """(r, n) u64 lanes -> (r, n) uniform residues floor(u * (q-1) / 2^64)
    (the integer-exact spec)."""
    return modmath.mulhi_u64(u64s, ms.q - 1)


# --- the reference-exact fp64 uniform spec (opt-in) --------------------------
#
# The reference computes d = (double)u; d /= UINT64_MAX; d *= (double)(q-1);
# out = (unsigned long long)d (uniform_dist_xq, bfv_keygen.cuh:33-45).  As in
# the JAX package (ntt_cuda_tpu/ops/sampling.py uniform_ref), the IEEE-double
# path is emulated exactly in integers: (double)u = RNE53(u), the division
# by (double)UINT64_MAX = 2^64 is an exact scaling, the multiply is
# RNE53(RNE53(u) RNE53(q-1)) 2^-64 and the cast truncates (>> 64).  Here in
# the port's int64-carried u64 idiom: unsigned compares XOR the sign bit,
# every right shift is masked to a logical one, and every shift amount is
# clamped to [0, 63] as the JAX code clamps it (torch.where evaluates both
# branches).  Plain tensor ops on the words' device, with no host read, so
# the keygen program stays capturable as a CUDA graph.

_SIGN = -(1 << 63)        # bit 63 alone, as an int64


def _ult(a, b):
    """a < b for u64 bit patterns."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def _shr(x, s):
    """Logical x >> s for u64 bit patterns, s in [0, 63]: an int, or a
    tensor of x's shape (no host copy either way: capturable)."""
    if isinstance(s, int):
        return x if s == 0 else (x >> s) & ((1 << (64 - s)) - 1)
    keep = torch.where(s == 0, -1, (1 << (64 - s).clamp(max=63)) - 1)
    return (x >> s) & keep


def _bitlen_u64(x):
    """Bit length of each u64 lane (0 for 0), by binary-search shifts."""
    n = torch.zeros_like(x)
    for k in (32, 16, 8, 4, 2, 1):
        big = ~_ult(x, torch.full_like(x, 1 << k))
        n = n + big.to(I64) * k
        x = torch.where(big, _shr(x, k), x)
    return n + (x != 0).to(I64)


def _rne53_u64(x):
    """RNE53(x) for u64 lanes -> (value, overflowed_to_2_64)."""
    L = _bitlen_u64(x)
    shift = L.clamp(min=53) - 53                       # 0..11
    keep = _shr(x, shift)
    rem = x & ((1 << shift) - 1)
    half = torch.where(shift > 0, 1 << (shift - 1).clamp(min=0, max=63), 0)
    up = ((rem > half) | ((rem == half) & ((keep & 1) == 1))) & (shift > 0)
    val = keep + up.to(I64)                            # <= 2^53
    ov = (L == 64) & (val == (1 << 53))
    return torch.where(ov, 0, val << shift), ov


def _rne53_128_shift64(hi, lo):
    """floor(RNE53(hi * 2^64 + lo) / 2^64) for 128-bit lane pairs."""
    L = torch.where(hi != 0, 64 + _bitlen_u64(hi), _bitlen_u64(lo))
    shift = L.clamp(min=53) - 53                       # 0..75
    ge64 = shift >= 64
    sh_lo = shift.clamp(max=63)
    sh_hi = torch.where(ge64, shift - 64, 63).clamp(max=63)
    keep = torch.where(
        ge64, _shr(hi, sh_hi),
        torch.where(shift == 0, lo,
                    (hi << (64 - sh_lo).clamp(max=63)) | _shr(lo, sh_lo)))
    # rem = prod & (2^shift - 1), half = 2^(shift-1), as 128-bit pairs
    rem_lo = torch.where(ge64, lo, lo & ((1 << sh_lo) - 1))
    rem_hi = torch.where(ge64, hi & ((1 << sh_hi) - 1), 0)
    # half's set bit (index shift - 1) lies in lo for shift <= 64, in hi
    # for shift >= 65
    half_in_hi = shift >= 65
    half_lo = torch.where(half_in_hi | (shift == 0), 0,
                          1 << (shift - 1).clamp(min=0, max=63))
    half_hi = torch.where(half_in_hi, 1 << (shift - 65).clamp(min=0, max=63),
                          0)
    gt = _ult(half_hi, rem_hi) | ((rem_hi == half_hi) & _ult(half_lo, rem_lo))
    eq = (rem_hi == half_hi) & (rem_lo == half_lo)
    up = ((gt | (eq & ((keep & 1) == 1))) & (shift > 0)).to(I64)
    val = keep + up                                    # <= 2^53
    # out = val * 2^shift >> 64
    return torch.where(ge64, val << sh_hi,
                       torch.where(shift == 0, 0,
                                   _shr(val, (64 - shift).clamp(min=0,
                                                                max=63))))


def uniform_ref(u64s: torch.Tensor, ms: modmath.ModulusSet) -> torch.Tensor:
    """(r, n) u64 lanes -> (r, n) residues under the reference's exact
    double-precision uniform spec (the block comment above), bit for bit
    the JAX package's uniform_ref, including its quirk that a result can
    exceed q - 1 where q - 1 needs more than 53 bits and rounds up."""
    qd, _ = _rne53_u64(ms.q - 1)                       # (r, 1); q-1 < 2^62
    av, av_ov = _rne53_u64(u64s)
    hi = torch.where(av_ov, qd, modmath.mulhi_u64(av, qd))
    lo = torch.where(av_ov, 0, av * qd)                # RNE53(u) == 2^64
    return _rne53_128_shift64(hi, lo)



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


def _stream(nbytes: int, nonce, encrypt: bool, key_byte: int, device):
    """The keystream covering `nbytes` at `nonce`'s effective nonce
    (encryption's map or keygen's): K1 for an int nonce, kernel 6 for a ()
    int64 tensor (on `device`, or the tensor's own where it is None)."""
    nb = -(-nbytes // 64)
    if isinstance(nonce, torch.Tensor):
        v = encrypt_nonce_t(nonce) if encrypt else keygen_nonce_t(nonce)
        return salsa20.keystream_words_batch(
            nb, v.reshape(1), key_byte=key_byte,
            device=v.device if device is None else device)[0]
    v = encrypt_nonce(nonce) if encrypt else keygen_nonce(nonce)
    return salsa20.keystream_words(nb, key_byte=key_byte, nonce=v,
                                   device=device)


@tracing.traced("ntt.draws")
def keygen_draws_compact(n: int, r: int, ms: modmath.ModulusSet,
                         key_byte: int = salsa20.DEFAULT_KEY_BYTE, nonce=0,
                         uniform_spec: str = "int"):
    """Keygen draws on ms's device: (s_b (n,) int32, a (r, n) uniform
    residues, e_d (n,) int32).  Byte layout (bfv_keygen.cuh:120-122):
    ternary bytes at 0, uniform u64 lanes at n, Gaussian u32 at n + 8rn.
    `nonce`: an int, or a () int64 tensor (module docstring).
    `uniform_spec`: "int" (uniform) or "fp64" (uniform_ref)."""
    ks = _stream(keygen_entropy_bytes(n, r), nonce, False, key_byte,
                 ms.q.device)
    s_b = ternary_int(salsa20.bytes_u8(ks, 0, n))
    ufn = uniform_ref if uniform_spec == "fp64" else uniform
    a = ufn(salsa20.bytes_u64(ks, n, r * n).reshape(r, n), ms)
    e_d = gaussian_int(salsa20.bytes_u32(ks, n + 8 * r * n, n))
    return s_b, a, e_d


def keygen_draws_rank(n: int, r: int, lo: int, hi: int,
                      ms: modmath.ModulusSet,
                      key_byte: int = salsa20.DEFAULT_KEY_BYTE, nonce=0,
                      block: int = 0, S: int | None = None):
    """One rank's keygen draws in the sharded programs, on ms's device (ms:
    moduli [lo, hi)): coefficients [block S, (block + 1) S) (S None: all
    n) of keygen_draws_compact's s_b, of its uniform a's rows [lo, hi) and
    of its e_d, each from the rank's own blocks of the stream (the JAX
    package's parallel/spmd.py:139-155 and spmd2d.py `_draw_slices`): the
    ternary bytes at block block S/64, row i's lanes at n/64 + i n/8 +
    block S/8, the Gaussian words at (n + 8rn)/64 + block S/16.  K1
    launches: one each, and one per row of a when S < n (the rows' slices
    are then apart in the stream, and are joined)."""
    S = n if S is None else S
    stream = dict(key_byte=key_byte, nonce=keygen_nonce(nonce),
                  device=ms.q.device)
    s_b = ternary_int(salsa20.bytes_u8(salsa20.keystream_words(
        S // 64, counter0=block * S // 64, **stream), 0, S))
    runs = [(lo, hi)] if S == n else [(i, i + 1) for i in range(lo, hi)]
    rows = [salsa20.bytes_u64(salsa20.keystream_words(
        (b - a) * S // 8, counter0=n // 64 + a * n // 8 + block * S // 8,
        **stream), 0, (b - a) * S).reshape(b - a, S) for a, b in runs]
    e_d = gaussian_int(salsa20.bytes_u32(salsa20.keystream_words(
        S // 16, counter0=(n + 8 * r * n) // 64 + block * S // 16, **stream),
        0, S))
    return s_b, uniform(rows[0] if len(rows) == 1 else torch.cat(rows),
                        ms), e_d


def encrypt_draws_slice(n: int, block: int, S: int,
                        key_byte: int = salsa20.DEFAULT_KEY_BYTE, nonce=0,
                        device=None):
    """One rank's encryption draws in the 2-D program: coefficients
    [block S, (block + 1) S) of encrypt_draws_compact's (u_b (S,), e_d
    (2, S)), from the rank's own blocks (the ternary bytes at block
    block S/64, e0 at n/64 + block S/16, e1 at 5n/64 + block S/16); three
    K1 launches."""
    stream = dict(key_byte=key_byte, nonce=encrypt_nonce(nonce),
                  device=device)
    u_b = ternary_int(salsa20.bytes_u8(salsa20.keystream_words(
        S // 64, counter0=block * S // 64, **stream), 0, S))
    e_d = gaussian_int(torch.stack([salsa20.bytes_u32(
        salsa20.keystream_words(S // 16,
                                counter0=base // 64 + block * S // 16,
                                **stream), 0, S)
        for base in (n, 5 * n)]))
    return u_b, e_d


@tracing.traced("ntt.draws")
def encrypt_draws_compact(n: int, key_byte: int = salsa20.DEFAULT_KEY_BYTE,
                          nonce=0, device=None):
    """Encryption draws: (u_b (n,) int32, e_d (2, n) int32).  Layout
    (bfv_encryption.cuh:247): ternary bytes at 0, e0 at n, e1 at 5n (the
    n words of e0 end where e1's begin: one view holds both).  `nonce`: an
    int, or a () int64 tensor (module docstring).  `device` None is the
    current CUDA device, or a tensor nonce's."""
    ks = _stream(encrypt_entropy_bytes(n), nonce, True, key_byte, device)
    u_b = ternary_int(salsa20.bytes_u8(ks, 0, n))
    e_d = gaussian_int(salsa20.bytes_u32(ks, n, 2 * n).reshape(2, n))
    return u_b, e_d


@tracing.traced("ntt.draws")
def encrypt_draws_compact_batch(n: int, nonces,
                                key_byte: int = salsa20.DEFAULT_KEY_BYTE,
                                device=None):
    """Batched compact encryption draws: (J,) nonces -> (u_b (J, n) int32,
    e_d (J, 2, n) int32), row j equal to encrypt_draws_compact(n,
    nonce=nonces[j]).  On a CUDA device one launch of
    `salsa20.encrypt_draws_batch` (k_salsa20_draws: the streams and the
    converters in one kernel, the nonces mapped there).  On the CPU the
    plain path, which the kernel is held to: kernel 6's plain stream for
    the J mapped nonces, every view taken for all J rows at once, then
    ternary_int and gaussian_int.  `nonces`: ints, a uint64 array, or a
    (J,) int64 tensor (module docstring).  `device` None is the current
    CUDA device, or a tensor's."""
    if isinstance(nonces, torch.Tensor) and device is None:
        device = nonces.device
    device = cuda.default_device(device, "encrypt_draws_compact_batch")
    if device.type == "cuda":
        return salsa20.encrypt_draws_batch(n, nonces, key_byte=key_byte,
                                           device=device)
    mapped = (encrypt_nonce_t(nonces) if isinstance(nonces, torch.Tensor)
              else encrypt_nonces(nonces))
    ks = salsa20.keystream_words_batch(-(-encrypt_entropy_bytes(n) // 64),
                                       mapped, key_byte=key_byte,
                                       device=device)
    u_b = ternary_int(salsa20.bytes_u8(ks, 0, n))
    e_d = gaussian_int(salsa20.bytes_u32(ks, n, 2 * n).reshape(-1, 2, n))
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


@tracing.traced("ntt.draws")
def relin_draws(n: int, r: int, k: int, ms: modmath.ModulusSet, nonce=0):
    """Draws of the k relinearization keys on ms's device: (a (k, r, n)
    uniform NTT-domain residues, e (k, r, n) Gaussian residues).  Key j
    owns the stream's bytes from j*(8rn + 4n): its r*n u64 lanes, then its
    n Gaussian words.  One keystream launch, and the k keys viewed
    together."""
    ks = salsa20.keystream_for_bytes(
        relin_entropy_bytes(n, r, k), key_byte=RELIN_KEY_BYTE,
        nonce=keygen_nonce(nonce), device=ms.q.device)
    return _key_draws(ks, n, r, k, ms)


def relin_draws_rank(n: int, r: int, k: int, lo: int, hi: int,
                     ms: modmath.ModulusSet, nonce=0, block: int = 0,
                     S: int | None = None):
    """One rank's relin_draws in the sharded programs (the JAX package's
    parallel/spmd_mult.py:700-714 and spmd2d_mult.py:446-455), ms the
    moduli [lo, hi): (a (k, hi - lo, S), e (k, hi - lo, S)), equal to
    relin_draws' rows [lo, hi) and coefficients [block S, (block + 1) S)
    (S None: all n)."""
    return _key_draws_rank(n, r, k, lo, hi, ms, RELIN_KEY_BYTE, nonce, 0,
                           block, S)


def _key_draws_rank(n: int, r: int, k: int, lo: int, hi: int,
                    ms: modmath.ModulusSet, key_byte: int, nonce,
                    block0: int, block: int = 0, S: int | None = None):
    """Rows [lo, hi) and coefficients [block S, (block + 1) S) (S None: all
    n) of the k switching keys of the stream region that starts at block
    `block0` (laid out as _key_draws'): key j's uniform row g from block
    block0 + j (8rn + 4n)/64 + g n/8 + block S/8, its Gaussian words from
    block0 + (j (8rn + 4n) + 8rn)/64 + block S/16, the coefficients' slice
    drawn on every rank of a row band.  Two K1 launches a key (the rows
    together) where S is n, else one a row and one for the words; the
    views, apart in the stream, are joined."""
    S = n if S is None else S
    kb = (8 * r * n + 4 * n) // 64       # blocks per key
    runs = [(lo, hi)] if S == n else [(i, i + 1) for i in range(lo, hi)]
    stream = dict(key_byte=key_byte, nonce=keygen_nonce(nonce),
                  device=ms.q.device)
    u, w = [], []
    for j in range(k):
        rows = [salsa20.bytes_u64(salsa20.keystream_words(
            (b - a) * S // 8,
            counter0=block0 + j * kb + a * n // 8 + block * S // 8,
            **stream), 0, (b - a) * S).reshape(b - a, S) for a, b in runs]
        u.append(rows[0] if len(rows) == 1 else torch.cat(rows))
        w.append(salsa20.bytes_u32(salsa20.keystream_words(
            S // 16, counter0=block0 + j * kb + r * n // 8 + block * S // 16,
            **stream), 0, S))
    return uniform(torch.stack(u), ms), small_res(gaussian_int(
        torch.stack(w)), ms.q)


def _key_draws(ks, n: int, r: int, k: int, ms: modmath.ModulusSet):
    """The k switching keys' (a, e) from one stream whose key j owns the
    bytes from j*(8rn + 4n): strided views over the k keys, (k, r, n)
    lanes and (k, n) Gaussian words."""
    kw = (8 * r * n + 4 * n) // 4        # words per key
    keys = ks[:k * kw].reshape(k, kw)
    u = salsa20.bytes_u64(keys, 0, r * n).reshape(k, r, n)
    w = salsa20.bytes_u32(keys, 8 * r * n, n)
    return uniform(u, ms), small_res(gaussian_int(w), ms.q)


# Galois-key draws: their own key byte (0x03), independent of the keygen /
# encrypt (0x01) and relin (0x02) streams at any nonce.
GALOIS_KEY_BYTE = 0x03


@tracing.traced("ntt.draws")
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
        ks = salsa20.keystream_words(
            region, key_byte=GALOIS_KEY_BYTE, nonce=keygen_nonce(nonce),
            counter0=int(g) * region, device=ms.q.device)
        a, e = _key_draws(ks, n, r, k, ms)
        a_rows.append(a)
        e_rows.append(e)
    return torch.stack(a_rows), torch.stack(e_rows)


def galois_draws_rank(n: int, r: int, k: int, elts, lo: int, hi: int,
                      ms: modmath.ModulusSet, nonce=0, block: int = 0,
                      S: int | None = None):
    """One rank's galois_draws in the sharded programs (the JAX package's
    parallel/spmd_mult.py:539-558 and spmd2d_mult.py:265-275), ms the
    moduli [lo, hi): (a (E, k, hi - lo, S), e (E, k, hi - lo, S)), equal
    to galois_draws' rows [lo, hi) and coefficients [block S, (block + 1)
    S) (S None: all n)."""
    region = (relin_entropy_bytes(n, r, k) + 63) // 64
    draws = [_key_draws_rank(n, r, k, lo, hi, ms, GALOIS_KEY_BYTE, nonce,
                             int(g) * region, block, S) for g in elts]
    return (torch.stack([a for a, _ in draws]),
            torch.stack([e for _, e in draws]))
