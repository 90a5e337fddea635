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
"""

from __future__ import annotations

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


def keystream_plain(nblocks: int, key_byte: int = DEFAULT_KEY_BYTE, nonce=0,
                    counter0=0, with_u64: bool = False, device=None):
    """Plain tensor keystream (the counterpart of `_keystream_xla`):
    (16, nblocks) int64 words, plus the (8, nblocks) u64 lanes when
    `with_u64`.  `nonce` and `counter0` are Python ints in [0, 2^64)."""
    nonce, counter0 = int(nonce), int(counter0)
    ctr = torch.arange(nblocks, dtype=I64, device=device) + (counter0 & MASK32)
    ctr_hi = ((ctr >> 32) + (counter0 >> 32)) & MASK32
    ctr = ctr & MASK32
    kw = _key_word(key_byte)

    def full(v):
        return torch.full((nblocks,), v, dtype=I64, device=device)

    j = [full(SIGMA_WORDS[0]), full(kw), full(kw), full(kw), full(kw),
         full(SIGMA_WORDS[1]), full(nonce & MASK32), full(nonce >> 32),
         ctr, ctr_hi, full(SIGMA_WORDS[2]), full(kw), full(kw), full(kw),
         full(kw), full(SIGMA_WORDS[3])]
    x = list(j)
    for _ in range(ROUNDS // 2):
        _double_round(x)
    bw = torch.stack([(x[i] + j[i]) & MASK32 for i in range(16)])
    if not with_u64:
        return bw
    return bw, bw[0::2] | (bw[1::2] << 32)


def keystream_block_words(nblocks: int, key_byte: int = DEFAULT_KEY_BYTE,
                          nonce=0, counter0=0, with_u64: bool = False,
                          device=None):
    """(16, nblocks) keystream words [and (8, nblocks) u64 lanes] on
    `device`: the Salsa20 kernel on a CUDA device, the plain version on
    the CPU."""
    device = torch.device(device if device is not None else "cpu")
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
