// BEHZ fast base conversions of EvalMult, one thread per coefficient.
//
// Replace the three TPU kernels of ntt_cuda_tpu/ops/behz_pallas.py, all
// launched through one pallas_call (_run, behz_pallas.py:315, call :339):
//   21a rns_to_bsk  (_make_rns_to_bsk_kernel, :183): q -> Bsk + sm_mrq
//   21b fast_floor  (_make_fast_floor_kernel, :227): floor(t x / q) in Bsk
//   21c bsk_to_q    (_make_bsk_to_q_kernel,   :258): Shenoy-Kumaresan
// The TPU grid walks (component, target modulus) in order and parks the
// prescaled source residues in VMEM scratch at the first target step.
// Here every conversion is independent per coefficient, so thread (c, i)
// loads the k source residues x[c, j, i] (a warp reads consecutive i:
// coalesced), prescales them into a 16-entry array (k <= 15) and loops
// over the targets, writing out[c, t, i].  k is a runtime bound, so nvcc
// keeps the array in local memory (128 bytes of stack a thread, cached in
// L1; `-Xptxas -v`: 32-34 registers, no spills).
//
// Band form: the same kernels for target rows [row0, row0 + rl) alone
// replace behz_pallas.py's rns_to_bsk_rows (:431), fast_floor_rows (:447)
// and bsk_to_q_rows (:464), all through _run's pallas_call (:339): one rank
// of the RNS-sharded EvalMult (parallel/spmd_mult.py) gathers every source
// row and computes its own band of targets.  out (and fast_floor's xb) hold
// rl rows; the targets index the banks at t in [row0, row0 + rl).
// bsk_to_q's target k is the padded layout's dropped-modulus slot and
// writes 0.  The full conversions are row0 = 0, rl = k + 1 (k for
// bsk_to_q).
//
// Arithmetic: every multiply is data x constant, so each is one Shoup
// multiply (modarith.cuh mul_shoup, canonical out) with a (w, floor(w
// 2^64 / m)) pair from the banks below, and inner products accumulate
// canonically.  The u32-limb pairs of the TPU banks are gone: Hopper has
// native u64 lanes and __umul64hi.  The banks are uniform across threads
// and small (at most 16 x 17 pairs), read through const __restrict__
// pointers (cached).  Outputs are canonical, so they equal
// ops/behz.py's Montgomery chains exactly.
//
// Bound on the card: each coefficient costs about k^2 + 3k Shoup products
// (k = r-1, up to 15) against (2k + 1) u64 of traffic, so the multiply
// term grows as k^2 and the bytes term as k; chip_smoke.py computes both
// per call.
//
// Banks (u64 rows; "w, ws" = constant and its Shoup companion):
//   qsrc (k, 6):    q_j; m_tilde (q/q_j)^-1 w, ws; t (q/q_j)^-1 w, ws;
//                   (q/q_j) mod m_tilde
//   tgt  (k+1, 9):  m; prod(q) w, ws; m_tilde^-1 w, ws; t w, ws;
//                   prod(q)^-1 w, ws            (all mod the Bsk modulus m)
//   amat (k+1, k, 2): (q/q_j) mod m, w, ws
//   bsrc (k, 5):    b_j; (B/b_j)^-1 w, ws; (B/b_j) mod m_sk w, ws
//   bmat (k, k, 2): (B/b_j) mod q_t, w, ws
//   bfin (k, 2):    prod(B) mod q_t, w, ws
//   glob (5):       m_sk; m_sk >> 1; prod(B)^-1 mod m_sk w, ws;
//                   -(prod q)^-1 mod m_tilde

#include "modarith.cuh"

#define BEHZ_MAX_K 16

struct BehzIO {
  const u64* x;    // (C, k or k+1, n) source residues
  const u64* xb;   // (C, rl, n) fast_floor's Bsk rows, else null
  u64* out;        // (C, rl, n): target rows [row0, row0 + rl)
  const u64* __restrict__ qsrc;
  const u64* __restrict__ tgt;
  const u64* __restrict__ amat;
  const u64* __restrict__ bsrc;
  const u64* __restrict__ bmat;
  const u64* __restrict__ bfin;
  const u64* __restrict__ glob;
  int k, n, row0, rl;
};

// Sum_j zp_j * w[j] mod m, canonical; w holds k (w, ws) pairs.
NTT_HD u64 inner(const u64* zp, const u64* w, int k, u64 m) {
  u64 acc = 0;
  for (int j = 0; j < k; ++j)
    acc = add_mod(acc, mul_shoup(zp[j], w[2 * j], w[2 * j + 1], m), m);
  return acc;
}

// 21a: q -> Bsk.  zp_j = x_j m_tilde (q/q_j)^-1 mod q_j; the m_tilde
// channel is u32-wrapping mask arithmetic; sm_mrq lifts r centered
// (r >= 2^31 -> r - 2^32 mod m), adds r prod(q) and divides by m_tilde.
NTT_HD void rns_to_bsk_body(long long idx, const BehzIO& io) {
  const int k = io.k, n = io.n;
  const long long c = idx / n;
  const int i = (int)(idx % n);
  const u64* x = io.x + (size_t)c * k * n + i;
  u64 zp[BEHZ_MAX_K];
  u32 ymt = 0;
  for (int j = 0; j < k; ++j) {
    const u64* s = io.qsrc + 6 * j;
    zp[j] = mul_shoup(x[(size_t)j * n], s[1], s[2], s[0]);
    ymt += (u32)zp[j] * (u32)s[5];
  }
  const u32 rr = ymt * (u32)io.glob[4];
  u64* o = io.out + (size_t)c * io.rl * n + i;
  for (int b = 0; b < io.rl; ++b) {
    const int t = io.row0 + b;
    const u64* g = io.tgt + 9 * t;
    const u64 m = g[0];
    const u64 y = inner(zp, io.amat + (size_t)2 * k * t, k, m);
    const u64 temp = rr >= (1u << 31) ? (u64)rr + (m - (1ull << 32)) : rr;
    const u64 s = add_mod(y, mul_shoup(temp, g[1], g[2], m), m);
    o[(size_t)b * n] = mul_shoup(s, g[3], g[4], m);
  }
}

// 21b: floor(t x / q) in Bsk = (t xb - conv(t xq)) prod(q)^-1 mod m.
NTT_HD void fast_floor_body(long long idx, const BehzIO& io) {
  const int k = io.k, n = io.n;
  const long long c = idx / n;
  const int i = (int)(idx % n);
  const u64* xq = io.x + (size_t)c * k * n + i;
  const u64* xb = io.xb + (size_t)c * io.rl * n + i;
  u64 zp[BEHZ_MAX_K];
  for (int j = 0; j < k; ++j) {
    const u64* s = io.qsrc + 6 * j;
    zp[j] = mul_shoup(xq[(size_t)j * n], s[3], s[4], s[0]);
  }
  u64* o = io.out + (size_t)c * io.rl * n + i;
  for (int b = 0; b < io.rl; ++b) {
    const int t = io.row0 + b;
    const u64* g = io.tgt + 9 * t;
    const u64 m = g[0];
    const u64 yb = mul_shoup(xb[(size_t)b * n], g[5], g[6], m);
    const u64 conv = inner(zp, io.amat + (size_t)2 * k * t, k, m);
    o[(size_t)b * n] = mul_shoup(sub_mod(yb, conv, m), g[7], g[8], m);
  }
}

// 21c: Shenoy-Kumaresan.  alpha = (conv_msk(xp) - x_msk) prod(B)^-1 mod
// m_sk, negative when alpha > m_sk / 2 (strict); out_t = conv_qt(xp) -/+
// |alpha| prod(B) mod q_t, and 0 at the pad target t = k.
NTT_HD void bsk_to_q_body(long long idx, const BehzIO& io) {
  const int k = io.k, n = io.n;
  const long long c = idx / n;
  const int i = (int)(idx % n);
  const u64* x = io.x + (size_t)c * (k + 1) * n + i;
  const u64 msk = io.glob[0];
  u64 xp[BEHZ_MAX_K];
  u64 cm = 0;
  for (int j = 0; j < k; ++j) {
    const u64* s = io.bsrc + 5 * j;
    xp[j] = mul_shoup(x[(size_t)j * n], s[1], s[2], s[0]);
    cm = add_mod(cm, mul_shoup(xp[j], s[3], s[4], msk), msk);
  }
  const u64 alpha = mul_shoup(sub_mod(cm, x[(size_t)k * n], msk), io.glob[2],
                              io.glob[3], msk);
  const bool neg = alpha > io.glob[1];
  const u64 mag = neg ? msk - alpha : alpha;
  u64* o = io.out + (size_t)c * io.rl * n + i;
  for (int b = 0; b < io.rl; ++b) {
    const int t = io.row0 + b;
    u64* ot = o + (size_t)b * n;
    if (t == k) {
      *ot = 0;
      continue;
    }
    const u64 q = io.qsrc[6 * t];
    const u64 cq = inner(xp, io.bmat + (size_t)2 * k * t, k, q);
    const u64 corr = mul_shoup(mag, io.bfin[2 * t], io.bfin[2 * t + 1], q);
    *ot = neg ? add_mod(cq, corr, q) : sub_mod(cq, corr, q);
  }
}

enum { BEHZ_RNS_TO_BSK = 0, BEHZ_FAST_FLOOR = 1, BEHZ_BSK_TO_Q = 2 };

static BehzIO behz_io(const void* x, const void* xb, void* out,
                      const void* qsrc, const void* tgt, const void* amat,
                      const void* bsrc, const void* bmat, const void* bfin,
                      const void* glob, int k, int n, int row0, int rl) {
  BehzIO io = {(const u64*)x,    (const u64*)xb,   (u64*)out,
               (const u64*)qsrc, (const u64*)tgt,  (const u64*)amat,
               (const u64*)bsrc, (const u64*)bmat, (const u64*)bfin,
               (const u64*)glob, k,                n,
               row0,             rl};
  return io;
}

// Targets: Bsk's k + 1 rows, or q's k rows and the pad slot k.
static bool behz_args_ok(int which, const void* xb, int C, int k, int n,
                         int row0, int rl) {
  return which >= BEHZ_RNS_TO_BSK && which <= BEHZ_BSK_TO_Q && C >= 1 &&
         k >= 1 && k <= BEHZ_MAX_K && n >= 1 && row0 >= 0 && rl >= 1 &&
         row0 + rl <= k + 1 && (which != BEHZ_FAST_FLOOR || xb != nullptr);
}

#ifdef __CUDACC__

__global__ void k_rns_to_bsk(BehzIO io, long long total) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < total) rns_to_bsk_body(idx, io);
}

__global__ void k_fast_floor(BehzIO io, long long total) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < total) fast_floor_body(idx, io);
}

__global__ void k_bsk_to_q(BehzIO io, long long total) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < total) bsk_to_q_body(idx, io);
}

// which: BEHZ_*; x (C, k or k+1, n), xb (C, rl, n) for fast_floor, out
// (C, rl, n) for target rows [row0, row0 + rl); every bank pointer is
// passed (a kernel reads its own).
extern "C" int ntt_behz(int which, const void* x, const void* xb, void* out,
                        const void* qsrc, const void* tgt, const void* amat,
                        const void* bsrc, const void* bmat, const void* bfin,
                        const void* glob, int C, int k, int n, int row0,
                        int rl, void* stream) {
  if (!behz_args_ok(which, xb, C, k, n, row0, rl))
    return (int)cudaErrorInvalidValue;
  const BehzIO io = behz_io(x, xb, out, qsrc, tgt, amat, bsrc, bmat, bfin,
                            glob, k, n, row0, rl);
  const long long total = (long long)C * n;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (which == BEHZ_RNS_TO_BSK)
    k_rns_to_bsk<<<blocks, threads, 0, s>>>(io, total);
  else if (which == BEHZ_FAST_FLOOR)
    k_fast_floor<<<blocks, threads, 0, s>>>(io, total);
  else
    k_bsk_to_q<<<blocks, threads, 0, s>>>(io, total);
  return (int)cudaGetLastError();
}

#else  // host build for the CPU tests: the coefficients in order

extern "C" int ntt_behz(int which, const void* x, const void* xb, void* out,
                        const void* qsrc, const void* tgt, const void* amat,
                        const void* bsrc, const void* bmat, const void* bfin,
                        const void* glob, int C, int k, int n, int row0,
                        int rl, void*) {
  if (!behz_args_ok(which, xb, C, k, n, row0, rl)) return 1;
  const BehzIO io = behz_io(x, xb, out, qsrc, tgt, amat, bsrc, bmat, bfin,
                            glob, k, n, row0, rl);
  for (long long idx = 0; idx < (long long)C * n; ++idx) {
    if (which == BEHZ_RNS_TO_BSK)
      rns_to_bsk_body(idx, io);
    else if (which == BEHZ_FAST_FLOOR)
      fast_floor_body(idx, io);
    else
      bsk_to_q_body(idx, io);
  }
  return 0;
}

#endif
