"""Salsa20/20 keystream in the block-position layout, and its slicers.

Counterpart of `ntt_cuda_tpu/ops/salsa20.py` (the reference's CSPRNG,
VecCrypt, distributions.cuh:48-155): fixed key byte (0x01 for
`generate_random_default`), the nonce in state words 6/7, a 64-bit block
counter in words 8/9.  The keystream is (16, nblocks): row p is word p of
every 64-byte block, so stream word w lives at [w % 16, w // 16].  Each
u32 word is held in an int64 tensor (values in [0, 2^32)).

With `with_u64` the keystream also comes with the pre-paired u64 lanes,
(8, nblocks) int64 bit patterns: lane j of block b = word 2j | word 2j+1
<< 32.  This is the one tensor that stands for the TPU kernel's lo8/hi8
planes; `block_words_u64_planes` slices it.

`keystream_block_words` launches the CUDA kernel (csrc/salsa20.cu) for a
CUDA device and runs `keystream_plain` for the CPU.
`keystream_block_words_batch` is its J-nonce counterpart (kernel 6): (J,)
nonces -> (J, 16, nblocks), one launch, row j equal to the single stream of
nonce j; the `_batch` slicers cut all J rows at once.  `device` None is the
current CUDA device (raising where there is none); the CPU only when asked
for.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import cuda
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


def _block_words(nblocks: int, key_byte: int, nonce_lo, nonce_hi,
                 counter0: int, device) -> torch.Tensor:
    """The 20-round keystream for nonce words of shape (..., 1) (or ()):
    (..., 16, nblocks) int64 words."""
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
    return torch.stack([(x[i] + j[i]) & MASK32 for i in range(16)], dim=-2)


def keystream_plain(nblocks: int, key_byte: int = DEFAULT_KEY_BYTE, nonce=0,
                    counter0=0, with_u64: bool = False, device=None):
    """Plain tensor keystream (the counterpart of `_keystream_xla`):
    (16, nblocks) int64 words, plus the (8, nblocks) u64 lanes when
    `with_u64`.  `nonce` and `counter0` are Python ints in [0, 2^64)."""
    nonce = int(nonce)
    word = lambda v: torch.tensor(v, dtype=I64, device=device)
    bw = _block_words(nblocks, key_byte, word(nonce & MASK32),
                      word(nonce >> 32), int(counter0), device)
    if not with_u64:
        return bw
    return bw, bw[0::2] | (bw[1::2] << 32)


def nonce_array(nonces) -> np.ndarray:
    """A nonce or (J,) nonces (ints, a uint64 array, or an int64 tensor of
    u64 bit patterns) as uint64."""
    if isinstance(nonces, torch.Tensor):
        return nonces.detach().cpu().to(I64).numpy().view(np.uint64)
    return np.asarray(nonces, dtype=np.uint64)


def nonce_tensor(nonces, device) -> torch.Tensor:
    """(J,) nonces as one int64 tensor of their u64 bit patterns on
    `device`."""
    return torch.from_numpy(nonce_array(nonces).view(np.int64).copy()).to(
        device)


def keystream_batch_plain(nblocks: int, nonces,
                          key_byte: int = DEFAULT_KEY_BYTE, counter0=0,
                          device=None) -> torch.Tensor:
    """Plain J-nonce keystream (the counterpart of the xla path's vmap):
    (J, 16, nblocks) int64 words, row j equal to
    keystream_plain(nblocks, nonce=nonces[j])."""
    v = nonce_tensor(nonces, device)[:, None]
    return _block_words(nblocks, key_byte, v & MASK32, (v >> 32) & MASK32,
                        int(counter0), device)


def keystream_block_words_batch(nblocks: int, nonces,
                                key_byte: int = DEFAULT_KEY_BYTE,
                                counter0=0, device=None) -> torch.Tensor:
    """(J,) nonces -> (J, 16, nblocks) keystream words on `device`: kernel 6
    on a CUDA device (the nonces go to the card as one (J,) int64 tensor of
    u64 bit patterns), the plain version on the CPU."""
    device = cuda.default_device(device, "keystream_block_words_batch")
    if device.type == "cpu":
        return keystream_batch_plain(nblocks, nonces, key_byte=key_byte,
                                     counter0=counter0, device=device)
    if device.type != "cuda":
        raise ValueError(f"keystream_block_words_batch: no kernel for "
                         f"{device}")
    v = nonce_tensor(nonces, device)
    if v.dim() != 1:
        raise ValueError(f"nonces: expected shape (J,), got {tuple(v.shape)}")
    bw = torch.empty((v.shape[0], 16, nblocks), dtype=I64, device=device)
    cuda.launch("ntt_salsa20_batch", device, bw.data_ptr(), nblocks,
                _key_word(key_byte), v.data_ptr(), v.shape[0],
                int(counter0))
    keystream_block_words_batch.launches += 1
    return bw


keystream_block_words_batch.launches = 0


def keystream_block_words(nblocks: int, key_byte: int = DEFAULT_KEY_BYTE,
                          nonce=0, counter0=0, with_u64: bool = False,
                          device=None):
    """(16, nblocks) keystream words [and (8, nblocks) u64 lanes] on
    `device`: the Salsa20 kernel on a CUDA device, the plain version on
    the CPU."""
    device = cuda.default_device(device, "keystream_block_words")
    if device.type == "cpu":
        return keystream_plain(nblocks, key_byte=key_byte, nonce=nonce,
                               counter0=counter0, with_u64=with_u64,
                               device=device)
    if device.type != "cuda":
        raise ValueError(f"keystream_block_words: no kernel for {device}")
    bw = torch.empty((16, nblocks), dtype=I64, device=device)
    lanes = (torch.empty((8, nblocks), dtype=I64, device=device)
             if with_u64 else None)
    cuda.launch("ntt_salsa20", device, bw.data_ptr(),
                lanes.data_ptr() if with_u64 else None, nblocks,
                _key_word(key_byte), int(nonce), int(counter0))
    keystream_block_words.launches += 1
    return (bw, lanes) if with_u64 else bw


keystream_block_words.launches = 0


def block_words_u32(bw: torch.Tensor, start: int, count: int) -> torch.Tensor:
    """`count` canonical-order stream words from byte offset `start`
    (start must be 64-byte block aligned)."""
    if start % 64:
        raise ValueError(f"start={start} is not 64-byte block aligned")
    blk0 = start // 64
    nb = -(-count // 16)
    return bw[:, blk0:blk0 + nb].T.reshape(nb * 16)[:count]


def block_words_u8(bw: torch.Tensor, start: int, count: int) -> torch.Tensor:
    """`count` keystream bytes from block-aligned byte offset `start`."""
    w = block_words_u32(bw, start, -(-count // 4))
    b = torch.stack([(w >> (8 * k)) & 0xFF for k in range(4)], dim=1)
    return b.reshape(-1)[:count]


def block_words_u64_planes(lanes: torch.Tensor, start: int,
                           count: int) -> torch.Tensor:
    """`count` little-endian u64 lanes (int64 bit patterns) from
    block-aligned byte offset `start`: lane k comes from row k % 8 of
    block k // 8 of the pre-paired lanes."""
    if start % 64 or count % 8:
        raise ValueError(f"start={start} / count={count}: need whole blocks")
    blk0 = start // 64
    nb = count // 8
    return lanes[:, blk0:blk0 + nb].T.reshape(-1)


def block_words_u32_batch(bw: torch.Tensor, start: int,
                          count: int) -> torch.Tensor:
    """Batched block_words_u32: (J, 16, nb_total) -> (J, count) stream
    words from block-aligned byte offset `start`, every row at once."""
    if start % 64:
        raise ValueError(f"start={start} is not 64-byte block aligned")
    blk0 = start // 64
    nb = -(-count // 16)
    w = bw[:, :, blk0:blk0 + nb].transpose(1, 2)
    return w.reshape(bw.shape[0], nb * 16)[:, :count]


def block_words_u8_batch(bw: torch.Tensor, start: int,
                         count: int) -> torch.Tensor:
    """Batched block_words_u8: (J, 16, nb_total) -> (J, count) bytes."""
    w = block_words_u32_batch(bw, start, -(-count // 4))
    b = torch.stack([(w >> (8 * k)) & 0xFF for k in range(4)], dim=2)
    return b.reshape(w.shape[0], -1)[:, :count]
