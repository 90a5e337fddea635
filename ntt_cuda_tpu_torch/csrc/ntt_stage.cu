// Stage-schedule transforms: one forward or inverse negacyclic NTT per
// launch, with an elementwise prologue (and, for the inverse, an epilogue)
// fused in.
//
// Replace the TPU kernels of ntt_cuda_tpu/ops/ntt_pallas.py:
//   7  _transform_tiled            (ntt_pallas.py:558, pallas_call :600)
//   8  _transform_inv_mul          (ntt_pallas.py:685, pallas_call :719)
//   9  _transform_fwd_ternary      (ntt_pallas.py:782, pallas_call :810)
//   10 _transform_fwd_addneg_gauss (ntt_pallas.py:959, pallas_call :993)
//   11 _transform_fwd_addneg       (ntt_pallas.py:868, pallas_call :902)
// the transform half of ntt_cuda_tpu/ops/bfv_tail.py encrypt_fused
// (13: bfv_tail.py:661, pallas_call :717), whose modulus drop and
// Delta*m + fix run in fused_ops.cu's ntt_encrypt_tail, and the two
// transforms of the key switch (19: fused_ops.py:651, pallas_call :697),
// whose modulus drop is the same tail launch.  The TPU kernels share one
// four-step transform (_stage_a / _stage_b) and differ in the prologue;
// here they share ntt_block.cuh's transform and differ in `pro`:
//   PRO_COPY          x                          (7)
//   PRO_TERNARY       small_res(d)               (9, d a compact ternary)
//   PRO_ADDNEG_GAUSS  -(x + small_res(d)), 0 fix (10, d a compact Gaussian)
//   PRO_MONT          x * y * 2^-64 (Montgomery) (8, 13)
//   PRO_ADDNEG        -(x + y), 0 fix            (11, y u64 at x's index)
//   PRO_DIGIT         x[p / r] mod q (mod_nu)    (19 forward: the digits)
//   PRO_KSACC         sum_j d^_j * ksk_j * 2^-64 (19 inverse: both key rows)
// The inverse ends with n^-1: a Shoup multiply by n^-1 * 2^64 after a
// Montgomery product (its 2^-64 cancels), else mont_mul by the same
// constant, which is x * n^-1.  Kernel 13 then adds e (strict `>`).
//
// Key switch (19).  The TPU kernel keeps one modulus per grid step in VMEM
// with k forward chains and two accumulators; a 2^14 polynomial fills a
// block's shared memory here, so the same function is two launches of
// this transform (and the tail):  PRO_DIGIT forward over P = J k r
// polynomials, p = (J k + j) r + mi reading c2[J, j] (the digit lifted to
// every modulus, q_last included) into d^ (J, k, r, n); then PRO_KSACC
// inverse over P = J 2 r, p = (J 2 + h) r + mi accumulating the k
// Montgomery products d^[J, j, mi] ksk[h, j, mi] canonically into
// (J, 2, r, n).  Every intermediate is a canonical residue, so the result
// equals the XLA chain of the JAX package exactly.
//
// Polynomial p has modulus p % r (the standard RNS layout); a compact draw
// row is shared by the r polynomials of one message (row p / r).
//
// n <= 2^14: one launch, one block per polynomial, resident in shared
// memory for its whole transform.  n = 2^15 (256 KB, over a block's
// 227 KB): the reference's hybrid schedule.  The forward runs CT stage 0
// (pairs i, i + n/2, twiddle psi[1]) with the prologue as an elementwise
// launch, then one launch of 2 blocks per polynomial runs stages 1..14 on
// each 2^14 half in shared memory (ntt_block.cuh's sub-range form).  The
// inverse runs the prologue and GS stages 14..1 on the halves, then GS
// stage 0 (ipsi[1]) and the epilogue as an elementwise launch.
//
// Bound on the card: at J = 1 a launch has r (or 2r) blocks for 132 SMs,
// and each of the log n stages ends in a block barrier, so the time is
// the latency of one block's stages, not device memory (one polynomial
// is read and written once per launch, twice at 2^15) or the multiplier
// rate.  The design keeps the transform in shared memory and reads the
// compact draws (i32 planes) instead of (r, n) u64 residues.

#include "ntt_block.cuh"

#ifndef __CUDACC__
#include <vector>
#endif

enum {
  PRO_COPY = 0,
  PRO_TERNARY = 1,
  PRO_ADDNEG_GAUSS = 2,
  PRO_MONT = 3,
  PRO_ADDNEG = 4,
  PRO_DIGIT = 5,
  PRO_KSACC = 6
};

struct StageIO {
  const u64* x;   // (P, n) input polynomials (unused for PRO_TERNARY);
                  // PRO_DIGIT: (P / r, n) rows; PRO_KSACC: d^ (J, k, r, n)
  const int* d;   // (P / r, n) compact draw (PRO_TERNARY, PRO_ADDNEG_GAUSS)
  const u64* y;   // PRO_MONT: (ny, n) dyadic operand, row p % ny;
                  // PRO_ADDNEG: (P, n) e; PRO_KSACC: ksk (2, k, r, n)
  const int* e;   // (P / r, n) compact Gaussian added by the inverse, or null
  const u64* nu;  // PRO_DIGIT: (r,) floor(2^64 / q)
  u64* out;       // (P, n)
  int pro, ny, r, logn;  // PRO_KSACC: ny = k, the number of digits
};

// A prologue that leaves a Montgomery factor 2^-64 for the inverse's end.
NTT_HD bool pro_mont(int pro) { return pro == PRO_MONT || pro == PRO_KSACC; }

NTT_HD u64 prologue(const StageIO& io, int p, int i, const ModConsts& c) {
  const size_t n = (size_t)1 << io.logn;
  const size_t at = (size_t)p * n + i;
  const size_t at_d = (size_t)(p / io.r) * n + i;
  switch (io.pro) {
    case PRO_TERNARY:
      return small_res(io.d[at_d], c.q);
    case PRO_ADDNEG_GAUSS:
      return add_neg_mod(io.x[at], small_res(io.d[at_d], c.q), c.q);
    case PRO_MONT:
      return mont_mul(io.x[at], io.y[(size_t)(p % io.ny) * n + i], c.q,
                      c.qinv);
    case PRO_ADDNEG:
      return add_neg_mod(io.x[at], io.y[at], c.q);
    case PRO_DIGIT:
      return mod_nu(io.x[at_d], c.q, io.nu[p % io.r]);
    case PRO_KSACC: {
      // p = (J 2 + h) r + mi; digit j of message J is row (J k + j) r + mi
      // of d^, key row (h k + j) r + mi
      const int k = io.ny, r = io.r, mi = p % r, h = (p / r) % 2;
      const size_t step = (size_t)r * n;
      const u64* dj = io.x + ((size_t)(p / (2 * r)) * k * r + mi) * n + i;
      const u64* kj = io.y + ((size_t)h * k * r + mi) * n + i;
      u64 acc = 0;
      for (int j = 0; j < k; ++j)
        acc = add_mod(acc, mont_mul(dj[j * step], kj[j * step], c.q, c.qinv),
                      c.q);
      return acc;
    }
    default:
      return io.x[at];
  }
}

// The inverse's last step on coefficient i of polynomial p.
NTT_HD u64 inv_finish(const StageIO& io, int p, int i, u64 v,
                      const ModConsts& c) {
  v = pro_mont(io.pro) ? mul_shoup(v, c.ninv, c.ninv_sh, c.q)
                       : mont_mul(v, c.ninv, c.q, c.qinv);
  if (io.e) {
    const size_t at_e = (size_t)(p / io.r) * ((size_t)1 << io.logn) + i;
    v = add_mod_gt(v, small_res(io.e[at_e], c.q), c.q);
  }
  return v;
}

// Block b is polynomial b >> split, half b & split (split = 1 at 2^15).
NTT_HD void fwd_block_body(int b, int tid, int nt, u64* s, StageIO io,
                           Twiddles tw) {
  const int split = io.logn > LOG_BLOCK_MAX;
  const int p = b >> split, h = b & split;
  const int mi = p % io.r;
  const int logb = io.logn - split;
  const int nb = 1 << logb;
  const ModConsts c = load_consts(tw.consts, mi);
  const Twiddles t = twiddles_at(tw, mi, 1 << io.logn);
  u64* ob = io.out + ((size_t)p << io.logn) + (size_t)h * nb;
  if (split) {
    for (int i = tid; i < nb; i += nt) s[i] = ob[i];  // after stage 0
  } else {
    for (int i = tid; i < nb; i += nt) s[i] = prologue(io, p, i, c);
  }
  ntt_fwd_block(s, logb, t, c.q, tid, nt, split ? 2 + h : 1);
  for (int i = tid; i < nb; i += nt) ob[i] = s[i];
}

NTT_HD void inv_block_body(int b, int tid, int nt, u64* s, StageIO io,
                           Twiddles tw) {
  const int split = io.logn > LOG_BLOCK_MAX;
  const int p = b >> split, h = b & split;
  const int mi = p % io.r;
  const int logb = io.logn - split;
  const int nb = 1 << logb;
  const ModConsts c = load_consts(tw.consts, mi);
  const Twiddles t = twiddles_at(tw, mi, 1 << io.logn);
  u64* ob = io.out + ((size_t)p << io.logn) + (size_t)h * nb;
  for (int i = tid; i < nb; i += nt) s[i] = prologue(io, p, h * nb + i, c);
  ntt_inv_block(s, logb, t, c.q, tid, nt, split ? 2 + h : 1);
  if (split) {
    for (int i = tid; i < nb; i += nt) ob[i] = s[i];  // stage 0 follows
  } else {
    for (int i = tid; i < nb; i += nt) ob[i] = inv_finish(io, p, i, s[i], c);
  }
}

// 2^15 only: CT stage 0 with the prologue, pair k of P * n/2.
NTT_HD void fwd_first_body(long long k, StageIO io, Twiddles tw) {
  const int half = 1 << (io.logn - 1);
  const int p = (int)(k / half), i = (int)(k % half);
  const int mi = p % io.r;
  const ModConsts c = load_consts(tw.consts, mi);
  const Twiddles t = twiddles_at(tw, mi, 1 << io.logn);
  u64 u = prologue(io, p, i, c), v = prologue(io, p, i + half, c);
  ct_butterfly(u, v, t.psi[1], t.psi_sh[1], c.q);
  u64* ob = io.out + ((size_t)p << io.logn);
  ob[i] = u;
  ob[i + half] = v;
}

// 2^15 only: GS stage 0 and the epilogue, in place on out.
NTT_HD void inv_last_body(long long k, StageIO io, Twiddles tw) {
  const int half = 1 << (io.logn - 1);
  const int p = (int)(k / half), i = (int)(k % half);
  const int mi = p % io.r;
  const ModConsts c = load_consts(tw.consts, mi);
  const Twiddles t = twiddles_at(tw, mi, 1 << io.logn);
  u64* ob = io.out + ((size_t)p << io.logn);
  u64 u = ob[i], v = ob[i + half];
  gs_butterfly(u, v, t.ipsi[1], t.ipsi_sh[1], c.q);
  ob[i] = inv_finish(io, p, i, u, c);
  ob[i + half] = inv_finish(io, p, i + half, v, c);
}

static StageIO stage_io(const void* x, const void* d, const void* y,
                        const void* e, const void* nu, void* out, int pro,
                        int ny, int r, int logn) {
  StageIO io = {(const u64*)x, (const int*)d,  (const u64*)y,
                (const int*)e, (const u64*)nu, (u64*)out,
                pro,           ny,             r,
                logn};
  return io;
}

static bool stage_args_ok(int pro, int P, int r, int ny, int logn) {
  return logn >= 1 && logn <= LOG_BLOCK_MAX + 1 && P >= 1 && r >= 1 &&
         P % r == 0 && pro >= PRO_COPY && pro <= PRO_KSACC &&
         (!pro_mont(pro) || ny >= 1) &&
         (pro != PRO_KSACC || P % (2 * r) == 0);
}

// What each direction takes: the forward reads x or a draw, the inverse
// ends with n^-1 after a copy or a Montgomery prologue.
static bool forward_pro(int pro) {
  return pro == PRO_COPY || pro == PRO_TERNARY || pro == PRO_ADDNEG_GAUSS ||
         pro == PRO_ADDNEG || pro == PRO_DIGIT;
}

static bool inverse_pro(int pro) {
  return pro == PRO_COPY || pro == PRO_MONT || pro == PRO_KSACC;
}

#ifdef __CUDACC__

__global__ void k_stage_fwd_block(StageIO io, Twiddles tw) {
  extern __shared__ u64 smem[];
  fwd_block_body(blockIdx.x, threadIdx.x, blockDim.x, smem, io, tw);
}

__global__ void k_stage_inv_block(StageIO io, Twiddles tw) {
  extern __shared__ u64 smem[];
  inv_block_body(blockIdx.x, threadIdx.x, blockDim.x, smem, io, tw);
}

__global__ void k_stage_fwd_first(StageIO io, Twiddles tw, long long total) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k < total) fwd_first_body(k, io, tw);
}

__global__ void k_stage_inv_last(StageIO io, Twiddles tw, long long total) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k < total) inv_last_body(k, io, tw);
}

template <typename K>
static int launch_pairs(K kernel, long long total, void* stream, StageIO io,
                        Twiddles tw) {
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(io, tw,
                                                                  total);
  return (int)cudaGetLastError();
}

// x, d, y, nu: prologue inputs; out (P, n).  pro: forward_pro().
extern "C" int ntt_stage_forward(const void* x, const void* d, const void* y,
                                 const void* nu, void* out, const void* psi,
                                 const void* psi_sh, const void* ipsi,
                                 const void* ipsi_sh, const void* consts,
                                 int pro, int P, int r, int logn,
                                 void* stream) {
  if (!stage_args_ok(pro, P, r, 1, logn) || !forward_pro(pro))
    return (int)cudaErrorInvalidValue;
  const StageIO io = stage_io(x, d, y, nullptr, nu, out, pro, 1, r, logn);
  const Twiddles tw = make_tw(psi, psi_sh, ipsi, ipsi_sh, consts);
  const int split = logn > LOG_BLOCK_MAX;
  if (split) {
    const int rc = launch_pairs(k_stage_fwd_first,
                                (long long)P << (logn - 1), stream, io, tw);
    if (rc != 0) return rc;
  }
  return launch_poly(k_stage_fwd_block, P << split, logn - split, stream, io,
                     tw);
}

// x, y, e: prologue and epilogue inputs; out (P, n).  pro: inverse_pro();
// ny: PRO_MONT's y rows, PRO_KSACC's digit count k.
extern "C" int ntt_stage_inverse(const void* x, const void* y, const void* e,
                                 void* out, const void* psi,
                                 const void* psi_sh, const void* ipsi,
                                 const void* ipsi_sh, const void* consts,
                                 int pro, int ny, int P, int r, int logn,
                                 void* stream) {
  if (!stage_args_ok(pro, P, r, ny, logn) || !inverse_pro(pro))
    return (int)cudaErrorInvalidValue;
  const StageIO io = stage_io(x, nullptr, y, e, nullptr, out, pro, ny, r,
                              logn);
  const Twiddles tw = make_tw(psi, psi_sh, ipsi, ipsi_sh, consts);
  const int split = logn > LOG_BLOCK_MAX;
  const int rc = launch_poly(k_stage_inv_block, P << split, logn - split,
                             stream, io, tw);
  if (rc != 0 || !split) return rc;
  return launch_pairs(k_stage_inv_last, (long long)P << (logn - 1), stream,
                      io, tw);
}

#else  // host build for the CPU tests: one thread per block, blocks in order

extern "C" int ntt_stage_forward(const void* x, const void* d, const void* y,
                                 const void* nu, void* out, const void* psi,
                                 const void* psi_sh, const void* ipsi,
                                 const void* ipsi_sh, const void* consts,
                                 int pro, int P, int r, int logn, void*) {
  if (!stage_args_ok(pro, P, r, 1, logn) || !forward_pro(pro)) return 1;
  const StageIO io = stage_io(x, d, y, nullptr, nu, out, pro, 1, r, logn);
  const Twiddles tw = make_tw(psi, psi_sh, ipsi, ipsi_sh, consts);
  const int split = logn > LOG_BLOCK_MAX;
  if (split)
    for (long long k = 0; k < ((long long)P << (logn - 1)); ++k)
      fwd_first_body(k, io, tw);
  std::vector<u64> s((size_t)1 << (logn - split));
  for (int b = 0; b < (P << split); ++b)
    fwd_block_body(b, 0, 1, s.data(), io, tw);
  return 0;
}

extern "C" int ntt_stage_inverse(const void* x, const void* y, const void* e,
                                 void* out, const void* psi,
                                 const void* psi_sh, const void* ipsi,
                                 const void* ipsi_sh, const void* consts,
                                 int pro, int ny, int P, int r, int logn,
                                 void*) {
  if (!stage_args_ok(pro, P, r, ny, logn) || !inverse_pro(pro)) return 1;
  const StageIO io = stage_io(x, nullptr, y, e, nullptr, out, pro, ny, r,
                              logn);
  const Twiddles tw = make_tw(psi, psi_sh, ipsi, ipsi_sh, consts);
  const int split = logn > LOG_BLOCK_MAX;
  std::vector<u64> s((size_t)1 << (logn - split));
  for (int b = 0; b < (P << split); ++b)
    inv_block_body(b, 0, 1, s.data(), io, tw);
  if (split)
    for (long long k = 0; k < ((long long)P << (logn - 1)); ++k)
      inv_last_body(k, io, tw);
  return 0;
}

#endif
