// Salsa20/20 keystream in the block-position layout.
//
// Replaces the TPU kernel ntt_cuda_tpu/ops/salsa20.py _keystream_pallas
// (salsa20.py:174, pallas_call :200).  Fixed key byte, nonce in state words
// 6/7, 64-bit block counter counter0 + b in words 8/9 (the reference's
// VecCrypt, distributions.cuh:48-155).  Output: word p of block b at
// bw[p * nb + b] (the (16, nb) layout), each u32 word zero-extended into a
// u64 lane of an int64 tensor.  With `lanes` it also writes the pre-paired
// u64 lanes: lane j of block b = word 2j | word 2j+1 << 32 at
// lanes[j * nb + b] (the (8, nb) counterpart of the TPU's lo8/hi8 planes).
//
// Bound on the card: 20 rounds of 32-bit add/xor/rotate on 16 registers per
// block, then 16 (or 24) coalesced stores; about a megabyte of output at
// keygen sizes.  One thread per 64-byte block, nothing shared.
//
// Kernel 6, ntt_salsa20_batch, replaces _keystream_pallas_batch
// (salsa20.py:249, pallas_call :283): the J streams of a batched
// encryption in one launch, message j's nonce read from a (J,) device array
// of u64 bit patterns (the TPU's scalar-prefetch row).  Grid: 64-byte
// blocks in x, messages in y; one thread per (message, block) runs the
// same salsa20_body as K1 and writes word p of block b at
// bw[(j * 16 + p) * nb + b], the (J, 16, nb) layout.  The block counter
// counter0 + b carries into word 9 as _salsa_chunk's does (salsa20.py:
// 130-132).  Bound: the J * 16 * nb * 8 bytes it writes.

#include "modarith.cuh"

NTT_HD u32 rotl32(u32 x, int c) { return (x << c) | (x >> (32 - c)); }

#define SALSA_QR(a, b, c, d)            \
  x[b] ^= rotl32(x[a] + x[d], 7);       \
  x[c] ^= rotl32(x[b] + x[a], 9);       \
  x[d] ^= rotl32(x[c] + x[b], 13);      \
  x[a] ^= rotl32(x[d] + x[c], 18);

NTT_HD void salsa20_body(long long b, u64* bw, u64* lanes, long long nb,
                         u32 kw, u64 nonce, u64 ctr0) {
  const u64 ctr = ctr0 + (u64)b;
  const u32 j[16] = {0x61707865u, kw, kw, kw, kw, 0x3320646Eu,
                     (u32)nonce, (u32)(nonce >> 32), (u32)ctr,
                     (u32)(ctr >> 32), 0x79622D32u, kw, kw, kw, kw,
                     0x6B206574u};
  u32 x[16];
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
  for (int p = 0; p < 16; ++p) x[p] = j[p];
  for (int i = 0; i < 10; ++i) {  // 20 rounds: 10 double rounds
    SALSA_QR(0, 4, 8, 12)
    SALSA_QR(5, 9, 13, 1)
    SALSA_QR(10, 14, 2, 6)
    SALSA_QR(15, 3, 7, 11)
    SALSA_QR(0, 1, 2, 3)
    SALSA_QR(5, 6, 7, 4)
    SALSA_QR(10, 11, 8, 9)
    SALSA_QR(15, 12, 13, 14)
  }
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
  for (int p = 0; p < 16; ++p) {
    x[p] += j[p];
    bw[p * nb + b] = x[p];
  }
  if (lanes) {
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
    for (int q = 0; q < 8; ++q)
      lanes[q * nb + b] = (u64)x[2 * q] | ((u64)x[2 * q + 1] << 32);
  }
}

#ifdef __CUDACC__

__global__ void k_salsa20(u64* bw, u64* lanes, long long nb, u32 kw, u64 nonce,
                          u64 ctr0) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b < nb) salsa20_body(b, bw, lanes, nb, kw, nonce, ctr0);
}

extern "C" int ntt_salsa20(void* bw, void* lanes, long long nb, u32 kw,
                           u64 nonce, u64 ctr0, void* stream) {
  if (nb < 1) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const long long blocks = (nb + threads - 1) / threads;
  k_salsa20<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (u64*)bw, (u64*)lanes, nb, kw, nonce, ctr0);
  return (int)cudaGetLastError();
}

__global__ void k_salsa20_batch(u64* bw, long long nb, u32 kw,
                                const u64* nonces, u64 ctr0) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long j = blockIdx.y;
  if (b < nb)
    salsa20_body(b, bw + j * 16 * nb, nullptr, nb, kw, nonces[j], ctr0);
}

extern "C" int ntt_salsa20_batch(void* bw, long long nb, u32 kw,
                                 const void* nonces, int J, u64 ctr0,
                                 void* stream) {
  if (nb < 1 || J < 1 || J > 65535) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const dim3 grid((unsigned)((nb + threads - 1) / threads), (unsigned)J);
  k_salsa20_batch<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (u64*)bw, nb, kw, (const u64*)nonces, ctr0);
  return (int)cudaGetLastError();
}

extern "C" const char* ntt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

#else  // host build for the CPU tests

extern "C" int ntt_salsa20(void* bw, void* lanes, long long nb, u32 kw,
                           u64 nonce, u64 ctr0, void*) {
  for (long long b = 0; b < nb; ++b)
    salsa20_body(b, (u64*)bw, (u64*)lanes, nb, kw, nonce, ctr0);
  return 0;
}

extern "C" int ntt_salsa20_batch(void* bw, long long nb, u32 kw,
                                 const void* nonces, int J, u64 ctr0, void*) {
  if (nb < 1 || J < 1 || J > 65535) return 1;
  for (long long j = 0; j < J; ++j)
    for (long long b = 0; b < nb; ++b)
      salsa20_body(b, (u64*)bw + j * 16 * nb, nullptr, nb, kw,
                   ((const u64*)nonces)[j], ctr0);
  return 0;
}

extern "C" const char* ntt_error_string(int) { return "host build"; }

#endif
