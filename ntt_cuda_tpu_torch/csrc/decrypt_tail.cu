// Decryption tail: (x +> c0) * t*gamma * inv_punctured mod q_i, the BEHZ
// fast conversion to {t, gamma}, and dec_round.
//
// Replaces the TPU kernel ntt_cuda_tpu/ops/bfv_tail.py decrypt_tail
// (bfv_tail.py:388, pallas_call :416).  The TPU grid walks the r-1
// residues in order and carries the two sums in VMEM scratch
// (bfv_tail.py:365-383).  Here one coefficient of one message belongs to
// a group of G adjacent lanes (grid (n G / 256, J)).  Member g loads its
// residue rows g, g + G, ... (at most ROWS, a template constant; rk need
// not be a multiple of G) all at once, then sums them
// (behz_sums_loaded); the group adds its partial sums with
// __shfl_xor_sync butterflies (behz_sums_add: a wrapping u64 add of x_t
// for pow2 t, an add mod t for odd t; x_g mod gamma), and member 0 runs
// dec_round.  Every sum is exact modular arithmetic, so the result does
// not depend on G or on the order.  The rule (dt_lg): G = 2 up to
// 10 rows (2x the warps of one thread a coefficient, each member's loads
// in flight together), then 4 up to 20 and 8 beyond, a member at most five
// rows.  One-row members (G = 8 at 32k_9q) lost to the parent's loop at
// J = 3, and G = 1, larger G, several coefficients a thread and smaller
// blocks were no faster than this rule (tools/behz_ab.py; PERF.md §6);
// at 9 rows two members of five beat four of three (kernel 17,
// tools/tail_ab.py).
// The host build runs the same partition: each member's rows, then the
// group's sum.
//
// Bound on the card: device memory, 16 (r-1) bytes read and 8 written per
// coefficient.  Each row costs two Shoup products (DecTailConsts.k2_rows:
// the reference's two Montgomery products by constants folded into one,
// and bcm_gamma's) where the reference runs three Montgomery products.
// Coalesced: a warp reads 32 / G consecutive coefficients of each of its
// rows.
//
// Mod-t strategy (bfv_tail._t_strategy): pow2 t uses the reference's mask
// forms (poly_arithmetic.cuh:217-268); odd t < 2^31 reduces by Barrett with
// nu_t = floor(2^64 / t) and ends with the gamma^-1 mod t undo.
//
// Kernel 17, decrypt_tail_partial, replaces ntt_cuda_tpu/ops/bfv_tail.py
// decrypt_tail_partial (bfv_tail.py:886, pallas_call :908): one rank of the
// RNS-sharded decrypt runs the same residue loop over its own rl rows and
// stops before the scaling and rounding.  It is K2's kernel with the partial
// epilogue (PARTIAL): the same members, rows, constants (the rank's band of
// K2's rows, DecPartialConsts.k2_rows: the dropped modulus's row and any
// q = 1 pad rows are zero constants and add nothing) and sums, and member 0
// writes the rank's two partial sums where K2 rounds: x_t as the low 32
// bits of the sum for pow2 t (the TPU kernel's wrapping u32 sum,
// bfv_tail.py:275-279), below t for odd t, and x_g below gamma, before the
// neg_inv_q multiply.  The caller all-reduces and rounds them
// (bfv_tail.dec_round_from_sums).  Its G is K2's rule on the band's rows
// (the launches of the sharded decrypt: rl = 3 and 9 at 32k_9q, G = 2).
// Bound as K2's: 16 rl bytes read and 16 written per coefficient.

#include "behz_sums.cuh"

#define DT_THREADS 256
#define DT_MAX_GROUP 8
#define DT_MAX_ROWS 16  // rows a member: rk <= G * DT_MAX_ROWS

// Member 0's epilogue: the plaintext coefficient (K2, out (J, n)), or
// the partial sums (kernel 17, out (J, 2, n): x_t, x_g).
template <bool PARTIAL>
NTT_HD void dt_finish(BehzSums s, long long j, int k, u64* out, const u64* gl,
                      int n, int pow2, u64 t, u64 neg_t, u64 nu_t,
                      u64 inv_gt) {
  if (PARTIAL) {
    out[(2 * j) * n + k] = pow2 ? s.xt & 0xFFFFFFFFull : s.xt;
    out[(2 * j + 1) * n + k] = s.xg;
  } else {
    out[j * n + k] = dec_round(s, gl, pow2, t, neg_t, nu_t, inv_gt);
  }
}

// Coefficient k of message j from its G members' partial sums (member g:
// rows g, g + G, ..., at most ROWS), added in member order (the host form
// of the kernel's butterflies).
template <int ROWS, bool PARTIAL>
NTT_HD void decrypt_tail_body(long long j, int k, const u64* x, const u64* c0,
                              u64* out, const u64* kr, const u64* gl, int rk,
                              int n, int pow2, u64 t, u64 neg_t, u64 nu_t,
                              u64 inv_gt, int G) {
  BehzSums s = behz_sums_loaded<ROWS>(j, k, x, c0, kr, gl, rk, n, pow2, t,
                                      nu_t, 0, G);
  for (int g = 1; g < G; ++g)
    s = behz_sums_add(s,
                      behz_sums_loaded<ROWS>(j, k, x, c0, kr, gl, rk, n, pow2,
                                             t, nu_t, g, G),
                      gl, pow2, t);
  dt_finish<PARTIAL>(s, j, k, out, gl, n, pow2, t, neg_t, nu_t, inv_gt);
}

// K2's group size G, as log2: the least G >= 2 that leaves a member at
// most five rows, up to DT_MAX_GROUP (PERF.md §6); -1 where a member
// would hold more than DT_MAX_ROWS.
static int dt_lg(int rk) {
  int lg = 1;
  while ((1 << lg) < DT_MAX_GROUP && 5 << lg < rk) ++lg;
  return rk <= DT_MAX_ROWS << lg ? lg : -1;
}

struct DtArgs {
  const u64 *x, *c0;
  u64* out;
  const u64 *kr, *gl;
  int J, rk, n, pow2;
  u64 t, neg_t, nu_t, inv_gt;
  int lg;
};

#ifdef __CUDACC__

template <int ROWS, bool PARTIAL>
__global__ void __launch_bounds__(DT_THREADS) k_decrypt_tail(DtArgs a) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  const int k = v >> a.lg, G = 1 << a.lg, g = v & (G - 1);
  const long long j = blockIdx.y;
  BehzSums s = {0, 0};
  if (k < a.n)
    s = behz_sums_loaded<ROWS>(j, k, a.x, a.c0, a.kr, a.gl, a.rk, a.n, a.pow2,
                               a.t, a.nu_t, g, G);
  for (int m = 1; m < G; m <<= 1) {
    const BehzSums o = {__shfl_xor_sync(0xffffffffu, s.xt, m),
                        __shfl_xor_sync(0xffffffffu, s.xg, m)};
    s = behz_sums_add(s, o, a.gl, a.pow2, a.t);
  }
  if (g == 0 && k < a.n)
    dt_finish<PARTIAL>(s, j, k, a.out, a.gl, a.n, a.pow2, a.t, a.neg_t,
                       a.nu_t, a.inv_gt);
}

template <int ROWS, bool PARTIAL>
static void dt_run(const DtArgs& a, void* stream) {
  const dim3 grid(
      (unsigned)((((long long)a.n << a.lg) + DT_THREADS - 1) / DT_THREADS),
      (unsigned)a.J);
  k_decrypt_tail<ROWS, PARTIAL><<<grid, DT_THREADS, 0, (cudaStream_t)stream>>>(
      a);
}

#else  // host build for the CPU tests: each coefficient's members in turn

template <int ROWS, bool PARTIAL>
static void dt_run(const DtArgs& a, void*) {
  for (long long j = 0; j < a.J; ++j)
    for (int k = 0; k < a.n; ++k)
      decrypt_tail_body<ROWS, PARTIAL>(j, k, a.x, a.c0, a.out, a.kr, a.gl,
                                       a.rk, a.n, a.pow2, a.t, a.neg_t,
                                       a.nu_t, a.inv_gt, 1 << a.lg);
}

#endif

// ROWS = ceil(rk / G) (runtime) -> the instantiation, 1..DT_MAX_ROWS.
template <bool PARTIAL, int ROWS = 1>
static void dt_dispatch(const DtArgs& a, void* stream) {
  const int G = 1 << a.lg;
  if ((a.rk + G - 1) / G <= ROWS || ROWS == DT_MAX_ROWS)
    dt_run<ROWS, PARTIAL>(a, stream);
  else if constexpr (ROWS < DT_MAX_ROWS)
    dt_dispatch<PARTIAL, ROWS + 1>(a, stream);
}

static bool dt_args(const void* x, const void* c0, void* out, const void* kr,
                    const void* gl, int J, int rk, int n, int pow2, u64 t,
                    u64 neg_t, u64 nu_t, u64 inv_gt, DtArgs& a) {
  a = {(const u64*)x, (const u64*)c0, (u64*)out, (const u64*)kr,
       (const u64*)gl, J,     rk,    n,     pow2,  t,
       neg_t,           nu_t,  inv_gt, dt_lg(rk)};
  return J >= 1 && J <= 65535 && n >= 1 && n <= (1 << 27) && rk >= 1 &&
         a.lg >= 0;
}

// The launchers' status: NTT_EINVAL-like for arguments the kernel does not
// take, else the launch's error (0 in the host build).
#ifdef __CUDACC__
#define DT_STATUS(ok) \
  ((ok) ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue)
#else
#define DT_STATUS(ok) ((ok) ? 0 : 1)
#endif

// K2: x, c0 (J, rk, n), out (J, n).
extern "C" int ntt_decrypt_tail(const void* x, const void* c0, void* out,
                                const void* kr, const void* gl, int J, int rk,
                                int n, int pow2, u64 t, u64 neg_t, u64 nu_t,
                                u64 inv_gt, void* stream) {
  DtArgs a;
  const bool ok = dt_args(x, c0, out, kr, gl, J, rk, n, pow2, t, neg_t, nu_t,
                          inv_gt, a);
  if (ok) dt_dispatch<false>(a, stream);
  return DT_STATUS(ok);
}

// Kernel 17: one rank's x, c0 (rl, n) and its band of K2's rows, out (2, n).
extern "C" int ntt_decrypt_tail_partial(const void* x, const void* c0,
                                        void* out, const void* kr,
                                        const void* gl, int rl, int n, int pow2,
                                        u64 t, u64 nu_t, void* stream) {
  DtArgs a;
  const bool ok = dt_args(x, c0, out, kr, gl, 1, rl, n, pow2, t, 0, nu_t, 0,
                          a);
  if (ok) dt_dispatch<true>(a, stream);
  return DT_STATUS(ok);
}

#ifndef __CUDACC__

// The host build's seam for the tests (the card's library has none): K2
// (partial 0, out (J, n)) or kernel 17 (partial 1, J = 1, out (2, n)) at a
// group size G the caller picks, a power of two up to 32 that leaves a
// member at most DT_MAX_ROWS rows: the partition the card would run at
// that G.
extern "C" int ntt_decrypt_tail_group(int partial, int group, const void* x,
                                      const void* c0, void* out,
                                      const void* kr, const void* gl, int J,
                                      int rk, int n, int pow2, u64 t,
                                      u64 neg_t, u64 nu_t, u64 inv_gt) {
  DtArgs a;
  if (!dt_args(x, c0, out, kr, gl, J, rk, n, pow2, t, neg_t, nu_t, inv_gt,
               a) ||
      (partial && J != 1))
    return 1;
  for (a.lg = 0; (1 << a.lg) < group && a.lg < 5; ++a.lg) {
  }
  if ((1 << a.lg) != group || rk > DT_MAX_ROWS * group) return 1;
  if (partial)
    dt_dispatch<true>(a, nullptr);
  else
    dt_dispatch<false>(a, nullptr);
  return 0;
}

#endif
