"""Salsa20/20 keystream in its byte order, and the draws' views of it.

Counterpart of `ntt_cuda_tpu/ops/salsa20.py` (the reference's CSPRNG,
VecCrypt, distributions.cuh:48-155): fixed key byte (0x01 for
`generate_random_default`), the nonce in state words 6/7, a 64-bit block
counter in words 8/9.  The keystream is the reference's byte buffer as
u32 words: one flat tensor of `nblocks * 16` words carried as int32 bit
patterns, word w holding stream bytes 4w..4w+3 little-endian (the JAX
package's flat `keystream_words`).

`keystream_words` launches K1 (csrc/salsa20.cu) for a CUDA device and runs
`keystream_words_plain` for the CPU; `keystream_words_batch` is its J-nonce
counterpart (kernel 6): (J,) nonces -> (J, nblocks * 16), one launch, row j
equal to the single stream of nonce j.  `device` None is the current CUDA
device (raising where there is none); the CPU only when asked for.
`keystream_words_batch` also takes its nonces as a (J,) int64 tensor on the
device and reads them there, with no host read: the entry of the draws
whose nonce lives on the card (a CUDA graph replays it at whatever value
the tensor then holds).  `encrypt_draws_batch` is kernel 6 fused with the
encryption draws' converters (k_salsa20_draws, CUDA only): the J streams'
ternary and Gaussian values, with no stream written.

`bytes_u8` / `bytes_u32` / `bytes_u64` read the stream as the reference
does (bfv_keygen.cuh:120-122, bfv_encryption.cuh:247): each is a view of
the stream's last axis, never a copy, so one call serves a single stream
and a (J, words) batch of them alike.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import cuda
from ..utils import tracing
from .modmath import I64

SIGMA_WORDS = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)  # "expand 32-byte k"
DEFAULT_KEY_BYTE = 0x01  # generate_random_default (distributions.cuh:261)
ROUNDS = 20
MASK32 = 0xFFFFFFFF


def _key_word(key_byte: int) -> int:
    return key_byte | (key_byte << 8) | (key_byte << 16) | (key_byte << 24)


def _rotl(x, c: int):
    return ((x << c) | (x >> (32 - c))) & MASK32


def _double_round(x):
    # column round then row round (distributions.cuh:83-115)
    for a, b, c, d in ((0, 4, 8, 12), (5, 9, 13, 1), (10, 14, 2, 6), (15, 3, 7, 11),
                       (0, 1, 2, 3), (5, 6, 7, 4), (10, 11, 8, 9), (15, 12, 13, 14)):
        x[b] = x[b] ^ _rotl((x[a] + x[d]) & MASK32, 7)
        x[c] = x[c] ^ _rotl((x[b] + x[a]) & MASK32, 9)
        x[d] = x[d] ^ _rotl((x[c] + x[b]) & MASK32, 13)
        x[a] = x[a] ^ _rotl((x[d] + x[c]) & MASK32, 18)


def _stream_words(nblocks: int, key_byte: int, nonce_lo, nonce_hi,
                  counter0: int, device) -> torch.Tensor:
    """The 20-round keystream for nonce words of shape (..., 1) (or ()):
    (..., nblocks * 16) int32 words in stream order."""
    ctr = torch.arange(nblocks, dtype=I64, device=device) + (counter0 & MASK32)
    ctr_hi = ((ctr >> 32) + (counter0 >> 32)) & MASK32
    ctr = ctr & MASK32
    kw = _key_word(key_byte)
    shape = torch.broadcast_shapes(nonce_lo.shape, (nblocks,))

    def full(v):
        return torch.full(shape, v, dtype=I64, device=device)

    j = [full(SIGMA_WORDS[0]), full(kw), full(kw), full(kw), full(kw),
         full(SIGMA_WORDS[1]), nonce_lo.expand(shape), nonce_hi.expand(shape),
         ctr.expand(shape), ctr_hi.expand(shape), full(SIGMA_WORDS[2]),
         full(kw), full(kw), full(kw), full(kw), full(SIGMA_WORDS[3])]
    x = list(j)
    for _ in range(ROUNDS // 2):
        _double_round(x)
    words = torch.stack([(x[i] + j[i]) & MASK32 for i in range(16)], dim=-1)
    # u32 values to their int32 bit patterns (the cast wraps modulo 2^32)
    return words.reshape(shape[:-1] + (nblocks * 16,)).to(torch.int32)


def keystream_words_plain(nblocks: int, key_byte: int = DEFAULT_KEY_BYTE,
                          nonce=0, counter0=0, device=None) -> torch.Tensor:
    """Plain tensor keystream (the counterpart of `_keystream_xla` in
    stream order): (nblocks * 16,) int32 words.  `nonce` and `counter0`
    are Python ints in [0, 2^64)."""
    nonce = int(nonce)
    word = lambda v: torch.tensor(v, dtype=I64, device=device)
    return _stream_words(nblocks, key_byte, word(nonce & MASK32),
                         word(nonce >> 32), int(counter0), device)


def nonce_array(nonces) -> np.ndarray:
    """A nonce or (J,) nonces (ints, a uint64 array, or an int64 tensor of
    u64 bit patterns) as uint64."""
    if isinstance(nonces, torch.Tensor):
        return nonces.detach().cpu().to(I64).numpy().view(np.uint64)
    return np.asarray(nonces, dtype=np.uint64)


def nonce_tensor(nonces, device) -> torch.Tensor:
    """(J,) nonces as one int64 tensor of their u64 bit patterns on
    `device`.  A tensor is taken as such (its values as int64 bit
    patterns), moved to `device` with no host read and no copy where it is
    there already."""
    if isinstance(nonces, torch.Tensor):
        return nonces.to(device=device, dtype=I64).contiguous()
    return torch.from_numpy(nonce_array(nonces).view(np.int64).copy()).to(
        device)


def keystream_words_batch_plain(nblocks: int, nonces,
                                key_byte: int = DEFAULT_KEY_BYTE, counter0=0,
                                device=None) -> torch.Tensor:
    """Plain J-nonce keystream (the counterpart of the xla path's vmap):
    (J, nblocks * 16) int32 words, row j equal to
    keystream_words_plain(nblocks, nonce=nonces[j])."""
    v = nonce_tensor(nonces, device)[:, None]
    return _stream_words(nblocks, key_byte, v & MASK32, (v >> 32) & MASK32,
                         int(counter0), device)


def keystream_words_batch(nblocks: int, nonces,
                          key_byte: int = DEFAULT_KEY_BYTE, counter0=0,
                          device=None) -> torch.Tensor:
    """(J,) nonces -> (J, nblocks * 16) int32 keystream words on `device`:
    kernel 6 on a CUDA device (the nonces go to the card as one (J,) int64
    tensor of u64 bit patterns; a tensor already there is read in place),
    the plain version on the CPU."""
    device = cuda.default_device(device, "keystream_words_batch")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"keystream_words_batch: no kernel for {device}")
    v = nonce_tensor(nonces, device)
    if v.dim() != 1:
        raise ValueError(f"nonces: expected shape (J,), got {tuple(v.shape)}")
    if device.type == "cpu":
        return keystream_words_batch_plain(nblocks, v, key_byte=key_byte,
                                           counter0=counter0, device=device)
    with tracing.launch("salsa20.keystream_words_batch"):
        ks = torch.empty((v.shape[0], nblocks * 16), dtype=torch.int32,
                         device=device)
        cuda.launch("ntt_salsa20_batch", device, ks.data_ptr(), nblocks,
                    _key_word(key_byte), v.data_ptr(), v.shape[0],
                    int(counter0))
    return ks


def encrypt_draws_batch(n: int, nonces, key_byte: int = DEFAULT_KEY_BYTE,
                        device=None):
    """(J,) user nonces -> the compact draws of a batched encryption, (u_b
    (J, n), e_d (J, 2, n)) int32, in one launch of k_salsa20_draws on a
    CUDA device: kernel 6's streams of the mapped nonces turned into
    ternary and Gaussian values in registers, with no stream written.  The
    nonces go as they are (ints, a uint64 array, or a (J,) int64 tensor of
    u64 bit patterns, read on the device in place); the kernel applies
    encryption's map.  n: a multiple of 64.  The CPU has no such kernel:
    sampling.encrypt_draws_compact_batch runs the plain stream and
    converters there."""
    device = cuda.default_device(device, "encrypt_draws_batch")
    if device.type != "cuda":
        raise ValueError(f"encrypt_draws_batch: no kernel for {device}")
    if n < 64 or n % 64:
        raise ValueError(f"encrypt_draws_batch: n={n} is not a multiple "
                         f"of 64")
    v = nonce_tensor(nonces, device)
    if v.dim() != 1:
        raise ValueError(f"nonces: expected shape (J,), got {tuple(v.shape)}")
    J = v.shape[0]
    with tracing.launch("salsa20.encrypt_draws_batch"):
        u_b = torch.empty((J, n), dtype=torch.int32, device=device)
        e_d = torch.empty((J, 2, n), dtype=torch.int32, device=device)
        cuda.launch("ntt_salsa20_draws", device, u_b.data_ptr(),
                    e_d.data_ptr(), n, _key_word(key_byte), v.data_ptr(), J)
    return u_b, e_d


def keystream_words(nblocks: int, key_byte: int = DEFAULT_KEY_BYTE, nonce=0,
                    counter0=0, device=None) -> torch.Tensor:
    """(nblocks * 16,) int32 keystream words on `device`: K1 on a CUDA
    device, the plain version on the CPU."""
    device = cuda.default_device(device, "keystream_words")
    if device.type == "cpu":
        return keystream_words_plain(nblocks, key_byte=key_byte, nonce=nonce,
                                     counter0=counter0, device=device)
    if device.type != "cuda":
        raise ValueError(f"keystream_words: no kernel for {device}")
    with tracing.launch("salsa20.keystream_words"):
        ks = torch.empty(nblocks * 16, dtype=torch.int32, device=device)
        cuda.launch("ntt_salsa20", device, ks.data_ptr(), nblocks,
                    _key_word(key_byte), int(nonce), int(counter0))
    return ks


def keystream_for_bytes(nbytes: int, **kw) -> torch.Tensor:
    """Keystream covering ceil(nbytes / 64) blocks, as flat int32 words."""
    return keystream_words(-(-nbytes // 64), **kw)


def bytes_u8(ks: torch.Tensor, start: int, count: int) -> torch.Tensor:
    """`count` stream bytes from byte offset `start`: a uint8 view of the
    stream's (..., words) last axis."""
    return ks.view(torch.uint8)[..., start:start + count]


def bytes_u32(ks: torch.Tensor, start: int, count: int) -> torch.Tensor:
    """`count` little-endian u32 words (int32 bit patterns) from byte
    offset `start`, a multiple of 4: a view of the stream."""
    if start % 4:
        raise ValueError(f"bytes_u32: start={start} is not 4-byte aligned")
    return ks[..., start // 4:start // 4 + count]


def bytes_u64(ks: torch.Tensor, start: int, count: int) -> torch.Tensor:
    """`count` little-endian u64 lanes (int64 bit patterns, as `uniform`
    takes them) from byte offset `start`, a multiple of 8: an int64 view of
    the stream.  A range that cannot be viewed raises; it is not copied."""
    if start % 8:
        raise ValueError(f"bytes_u64: start={start} is not 8-byte aligned")
    return ks[..., start // 4:start // 4 + 2 * count].view(torch.int64)
