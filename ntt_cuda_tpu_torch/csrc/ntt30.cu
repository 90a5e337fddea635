// Kernel 22: the 30-bit family's negacyclic NTT / inverse NTT on u32
// residues (q < 2^30), n up to 65536.
//
// Replaces ntt_cuda_tpu/ops/ntt_pallas30.py _transform30 (:257, pallas_call
// :288, kernel _make_kernel30 :235): a four-step roll+select transform over
// (n1, 128) u32 tiles with pre-expanded stage-A tables.  Here the index
// algebra is the reference's own (ntt_block.cuh, ops/ntt.py): forward CT,
// natural order in, bit-reversed out, twiddle psi[len + ps]; inverse GS
// without halving, bit-reversed in, natural out, ending with one Shoup
// multiply by n^-1.  Every butterfly is the 32-bit Shoup form
// t = v w - umulhi(v, wp) q (mod 2^32) in [0, 2q), then one conditional
// subtract: values stay canonical in [0, q) throughout.
//
// Polynomial p of the (P, n) input has modulus p % r.  n <= 2^15: one
// block per polynomial, resident in 4n bytes of dynamic shared memory
// (128 KB at 2^15) for all log n stages.  n = 2^16 (256 KB, over a block's
// 227 KB): the forward runs CT stage 0 (pairs i, i + n/2, twiddle psi[1])
// as an elementwise launch, then one launch of two 2^15 half blocks per
// polynomial (ntt_block.cuh's sub-range form, tw_mul = 2 + h); the inverse
// runs the halves, then GS stage 0 (psi^-1[1]) with n^-1 elementwise.
//
// Bound on the card: at bench.py's 16 polynomials a launch has 16 (or 32)
// blocks for 132 SMs, and each of the log n stages ends in a block
// barrier, so the time is one block's latency, not device memory (4n
// bytes read and written per polynomial) or the multiplier (3 integer
// multiplies per butterfly).  The design keeps the whole transform in
// shared memory at half the u64 footprint, which is what lets 2^15 fit one
// block.  Simple first: no register tiling of stages, no lazy 4q bound.

#include "ntt_block.cuh"

#ifndef __CUDACC__
#include <vector>
#endif

// The longest polynomial one block holds: 2^15 u32, 128 KB.
#define LOG_BLOCK_MAX30 15

struct T30IO {
  const u32* x;  // (P, n) input
  u32* out;      // (P, n) output (may be x)
  int r, logn;
};

NTT_HD u32 q_of(const Twiddles32& tw, int mi) { return tw.consts[4 * mi]; }

// Block b is polynomial b >> split, half b & split (split = 1 at 2^16).
NTT_HD void fwd30_block_body(int b, int tid, int nt, u32* s, T30IO io,
                             Twiddles32 tw) {
  const int split = io.logn > LOG_BLOCK_MAX30;
  const int p = b >> split, h = b & split;
  const int mi = p % io.r;
  const int logb = io.logn - split;
  const int nb = 1 << logb;
  const u32 q = q_of(tw, mi);
  const size_t off = ((size_t)p << io.logn) + (size_t)h * nb;
  const u32* src = split ? io.out : io.x;  // after stage 0: in place on out
  for (int i = tid; i < nb; i += nt) s[i] = src[off + i];
  ntt_fwd_block(s, logb, twiddles_at(tw, mi, 1 << io.logn), q, tid, nt,
                split ? 2 + h : 1);
  for (int i = tid; i < nb; i += nt) io.out[off + i] = s[i];
}

NTT_HD void inv30_block_body(int b, int tid, int nt, u32* s, T30IO io,
                             Twiddles32 tw) {
  const int split = io.logn > LOG_BLOCK_MAX30;
  const int p = b >> split, h = b & split;
  const int mi = p % io.r;
  const int logb = io.logn - split;
  const int nb = 1 << logb;
  const u32 q = q_of(tw, mi);
  const u32 ninv = tw.consts[4 * mi + 1], ninv_sh = tw.consts[4 * mi + 2];
  const size_t off = ((size_t)p << io.logn) + (size_t)h * nb;
  for (int i = tid; i < nb; i += nt) s[i] = io.x[off + i];
  ntt_inv_block(s, logb, twiddles_at(tw, mi, 1 << io.logn), q, tid, nt,
                split ? 2 + h : 1);
  for (int i = tid; i < nb; i += nt)  // at 2^16 stage 0 and n^-1 follow
    io.out[off + i] = split ? s[i] : mul_shoup32(s[i], ninv, ninv_sh, q);
}

// 2^16 only: CT stage 0 of pair k of P * n/2, x -> out.
NTT_HD void fwd30_first_body(long long k, T30IO io, Twiddles32 tw) {
  const long long half = 1ll << (io.logn - 1);
  const long long p = k / half, i = k % half;
  const int mi = (int)(p % io.r);
  const size_t at = ((size_t)p << io.logn) + (size_t)i;
  const Twiddles32 t = twiddles_at(tw, mi, 1 << io.logn);
  u32 u = io.x[at], v = io.x[at + half];
  ct_butterfly(u, v, t.psi[1], t.psi_sh[1], q_of(tw, mi));
  io.out[at] = u;
  io.out[at + half] = v;
}

// 2^16 only: GS stage 0 and n^-1, in place on out.
NTT_HD void inv30_last_body(long long k, T30IO io, Twiddles32 tw) {
  const long long half = 1ll << (io.logn - 1);
  const long long p = k / half, i = k % half;
  const int mi = (int)(p % io.r);
  const size_t at = ((size_t)p << io.logn) + (size_t)i;
  const Twiddles32 t = twiddles_at(tw, mi, 1 << io.logn);
  const u32 q = q_of(tw, mi);
  const u32 ninv = tw.consts[4 * mi + 1], ninv_sh = tw.consts[4 * mi + 2];
  u32 u = io.out[at], v = io.out[at + half];
  gs_butterfly(u, v, t.ipsi[1], t.ipsi_sh[1], q);
  io.out[at] = mul_shoup32(u, ninv, ninv_sh, q);
  io.out[at + half] = mul_shoup32(v, ninv, ninv_sh, q);
}

static bool t30_args_ok(int P, int r, int logn) {
  return logn >= 1 && logn <= LOG_BLOCK_MAX30 + 1 && P >= 1 && r >= 1 &&
         P % r == 0;
}

static T30IO t30_io(const void* x, void* out, int r, int logn) {
  T30IO io = {(const u32*)x, (u32*)out, r, logn};
  return io;
}

static Twiddles32 t30_tw(const void* psi, const void* psi_sh, const void* ipsi,
                         const void* ipsi_sh, const void* consts) {
  Twiddles32 tw = {(const u32*)psi, (const u32*)psi_sh, (const u32*)ipsi,
                   (const u32*)ipsi_sh, (const u32*)consts};
  return tw;
}

#ifdef __CUDACC__

__global__ void k_ntt30_fwd_block(T30IO io, Twiddles32 tw) {
  extern __shared__ u32 smem32[];
  fwd30_block_body(blockIdx.x, threadIdx.x, blockDim.x, smem32, io, tw);
}

__global__ void k_ntt30_inv_block(T30IO io, Twiddles32 tw) {
  extern __shared__ u32 smem32[];
  inv30_block_body(blockIdx.x, threadIdx.x, blockDim.x, smem32, io, tw);
}

__global__ void k_ntt30_fwd_first(T30IO io, Twiddles32 tw, long long total) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k < total) fwd30_first_body(k, io, tw);
}

__global__ void k_ntt30_inv_last(T30IO io, Twiddles32 tw, long long total) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k < total) inv30_last_body(k, io, tw);
}

template <typename K>
static int launch_pairs30(K kernel, long long total, void* stream, T30IO io,
                          Twiddles32 tw) {
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(io, tw,
                                                                  total);
  return (int)cudaGetLastError();
}

// x, out (P, n) u32 (out may be x); tables from NTTTables30; inverse 0/1.
extern "C" int ntt30_transform(const void* x, void* out, const void* psi,
                               const void* psi_sh, const void* ipsi,
                               const void* ipsi_sh, const void* consts,
                               int inverse, int P, int r, int logn,
                               void* stream) {
  if (!t30_args_ok(P, r, logn)) return (int)cudaErrorInvalidValue;
  const T30IO io = t30_io(x, out, r, logn);
  const Twiddles32 tw = t30_tw(psi, psi_sh, ipsi, ipsi_sh, consts);
  const int split = logn > LOG_BLOCK_MAX30;
  const long long pairs = (long long)P << (logn - 1);
  if (!inverse) {
    if (split) {
      const int rc = launch_pairs30(k_ntt30_fwd_first, pairs, stream, io, tw);
      if (rc != 0) return rc;
    }
    return launch_poly<u32>(k_ntt30_fwd_block, P << split, logn - split,
                            stream, io, tw);
  }
  const int rc = launch_poly<u32>(k_ntt30_inv_block, P << split,
                                  logn - split, stream, io, tw);
  if (rc != 0 || !split) return rc;
  return launch_pairs30(k_ntt30_inv_last, pairs, stream, io, tw);
}

#else  // host build for the CPU tests: one thread per block, blocks in order

extern "C" int ntt30_transform(const void* x, void* out, const void* psi,
                               const void* psi_sh, const void* ipsi,
                               const void* ipsi_sh, const void* consts,
                               int inverse, int P, int r, int logn, void*) {
  if (!t30_args_ok(P, r, logn)) return NTT_EINVAL;
  const T30IO io = t30_io(x, out, r, logn);
  const Twiddles32 tw = t30_tw(psi, psi_sh, ipsi, ipsi_sh, consts);
  const int split = logn > LOG_BLOCK_MAX30;
  const long long pairs = (long long)P << (logn - 1);
  std::vector<u32> s((size_t)1 << (logn - split));
  if (!inverse) {
    if (split)
      for (long long k = 0; k < pairs; ++k) fwd30_first_body(k, io, tw);
    for (int b = 0; b < (P << split); ++b)
      fwd30_block_body(b, 0, 1, s.data(), io, tw);
    return 0;
  }
  for (int b = 0; b < (P << split); ++b)
    inv30_block_body(b, 0, 1, s.data(), io, tw);
  if (split)
    for (long long k = 0; k < pairs; ++k) inv30_last_body(k, io, tw);
  return 0;
}

#endif
