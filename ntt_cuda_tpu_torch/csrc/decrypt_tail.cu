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
// 8 rows (2x the warps of one thread a coefficient, each member's loads in
// flight together), then 4 up to 16 and 8 beyond, a member at most four
// rows.  One-row members (G = 8 at 32k_9q) lost to the parent's loop at
// J = 3, and G = 1, larger G, several coefficients a thread and smaller
// blocks were no faster than this rule (tools/behz_ab.py; PERF.md §6).
// The host build runs the same partition: each member's rows, then the
// group's sum.
//
// Bound on the card: device memory, 16 (r-1) bytes read and 8 written per
// coefficient.  Each row costs two Shoup products (DecTailConsts.k2_rows:
// the reference's two Montgomery products by constants folded into one,
// and bcm_gamma's) where kernels 15 and 17 run three Montgomery products.
// Coalesced: a warp reads 32 / G consecutive coefficients of each of its
// rows.
//
// Mod-t strategy (bfv_tail._t_strategy): pow2 t uses the reference's mask
// forms (poly_arithmetic.cuh:217-268); odd t < 2^31 reduces by Barrett with
// nu_t = floor(2^64 / t) and ends with the gamma^-1 mod t undo.
//
// Kernel 17, decrypt_tail_partial, replaces ntt_cuda_tpu/ops/bfv_tail.py
// decrypt_tail_partial (bfv_tail.py:886, pallas_call :908): one rank of the
// RNS-sharded decrypt runs the same residue loop over its own rows (the
// dropped modulus's and any pad rows give 0: their padded constants are 0)
// and stops before the scaling and rounding.  It writes the rank's two
// partial sums, which the caller all-reduces and rounds
// (bfv_tail.dec_round_from_sums): x_t as the low 32 bits of the sum for pow2
// t (the TPU kernel's wrapping u32 sum, bfv_tail.py:275-279), below t for
// odd t; x_g below gamma, before the neg_inv_q multiply.  Bound as above:
// 16 rl bytes read and 16 written per coefficient.

#include "behz_sums.cuh"

#define DT_THREADS 256
#define DT_MAX_GROUP 8
#define DT_MAX_ROWS 16  // rows a member: rk <= G * DT_MAX_ROWS

// Coefficient k of message j from its G members' partial sums (member g:
// rows g, g + G, ..., at most ROWS), added in member order (the host form
// of the kernel's butterflies).
template <int ROWS>
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
  out[(size_t)j * n + k] = dec_round(s, gl, pow2, t, neg_t, nu_t, inv_gt);
}

// K2's group size G, as log2: the least G >= 2 that leaves a member at
// most four rows, up to DT_MAX_GROUP (PERF.md §6); -1 where a member
// would hold more than DT_MAX_ROWS.
static int dt_lg(int rk) {
  int lg = 1;
  while ((1 << lg) < DT_MAX_GROUP && 4 << lg < rk) ++lg;
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

// Kernel 17: coefficient k's partial sums over the rank's rl rows, x_t to
// out[k] (its low 32 bits) and x_g to out[n + k].
NTT_HD void decrypt_partial_body(long long k, const u64* x, const u64* c0,
                                 u64* out, const u64* pm, const u64* gl, int rl,
                                 int n, int pow2, u64 t, u64 nu_t) {
  const BehzSums acc = behz_sums(0, (int)k, x, c0, pm, gl, rl, n, pow2, t, nu_t);
  out[k] = acc.xt & 0xFFFFFFFFull;
  out[n + k] = acc.xg;
}

#ifdef __CUDACC__

template <int ROWS>
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
    a.out[j * a.n + k] =
        dec_round(s, a.gl, a.pow2, a.t, a.neg_t, a.nu_t, a.inv_gt);
}

template <int ROWS>
static void dt_run(const DtArgs& a, cudaStream_t s) {
  const dim3 grid(
      (unsigned)((((long long)a.n << a.lg) + DT_THREADS - 1) / DT_THREADS),
      (unsigned)a.J);
  k_decrypt_tail<ROWS><<<grid, DT_THREADS, 0, s>>>(a);
}

#else  // host build for the CPU tests: each coefficient's members in turn

template <int ROWS>
static void dt_run(const DtArgs& a, void*) {
  for (long long j = 0; j < a.J; ++j)
    for (int k = 0; k < a.n; ++k)
      decrypt_tail_body<ROWS>(j, k, a.x, a.c0, a.out, a.kr, a.gl, a.rk, a.n,
                              a.pow2, a.t, a.neg_t, a.nu_t, a.inv_gt,
                              1 << a.lg);
}

#endif

// ROWS = ceil(rk / G) (runtime) -> the instantiation, 1..DT_MAX_ROWS.
template <int ROWS = 1, class S>
static void dt_dispatch(const DtArgs& a, S stream) {
  const int G = 1 << a.lg;
  if ((a.rk + G - 1) / G <= ROWS || ROWS == DT_MAX_ROWS)
    dt_run<ROWS>(a, stream);
  else if constexpr (ROWS < DT_MAX_ROWS)
    dt_dispatch<ROWS + 1>(a, stream);
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

#ifdef __CUDACC__

__global__ void k_decrypt_partial(const u64* x, const u64* c0, u64* out,
                                  const u64* pm, const u64* gl, int rl, int n,
                                  int pow2, u64 t, u64 nu_t) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k < n) decrypt_partial_body(k, x, c0, out, pm, gl, rl, n, pow2, t, nu_t);
}

// x, c0 (J, rk, n), out (J, n).
extern "C" int ntt_decrypt_tail(const void* x, const void* c0, void* out,
                                const void* kr, const void* gl, int J, int rk,
                                int n, int pow2, u64 t, u64 neg_t, u64 nu_t,
                                u64 inv_gt, void* stream) {
  DtArgs a;
  if (!dt_args(x, c0, out, kr, gl, J, rk, n, pow2, t, neg_t, nu_t, inv_gt,
               a))
    return (int)cudaErrorInvalidValue;
  dt_dispatch(a, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

extern "C" int ntt_decrypt_tail_partial(const void* x, const void* c0,
                                        void* out, const void* pm,
                                        const void* gl, int rl, int n, int pow2,
                                        u64 t, u64 nu_t, void* stream) {
  if (n < 1 || rl < 1) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  k_decrypt_partial<<<(n + threads - 1) / threads, threads, 0,
                      (cudaStream_t)stream>>>(
      (const u64*)x, (const u64*)c0, (u64*)out, (const u64*)pm,
      (const u64*)gl, rl, n, pow2, t, nu_t);
  return (int)cudaGetLastError();
}

#else  // host build for the CPU tests

extern "C" int ntt_decrypt_tail(const void* x, const void* c0, void* out,
                                const void* kr, const void* gl, int J, int rk,
                                int n, int pow2, u64 t, u64 neg_t, u64 nu_t,
                                u64 inv_gt, void* stream) {
  DtArgs a;
  if (!dt_args(x, c0, out, kr, gl, J, rk, n, pow2, t, neg_t, nu_t, inv_gt,
               a))
    return 1;
  dt_dispatch(a, stream);
  return 0;
}

extern "C" int ntt_decrypt_tail_partial(const void* x, const void* c0,
                                        void* out, const void* pm,
                                        const void* gl, int rl, int n, int pow2,
                                        u64 t, u64 nu_t, void*) {
  if (n < 1 || rl < 1) return 1;
  for (long long k = 0; k < n; ++k)
    decrypt_partial_body(k, (const u64*)x, (const u64*)c0, (u64*)out,
                         (const u64*)pm, (const u64*)gl, rl, n, pow2, t, nu_t);
  return 0;
}

#endif
