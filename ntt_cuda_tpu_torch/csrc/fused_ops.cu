// Whole-op transform kernels: half_polymul, keygen_fused, encrypt_fused,
// encrypt_front, and the RNS-sharded program's encrypt tail.
//
// Replace the TPU kernels of ntt_cuda_tpu/ops/fused_ops.py:
//   half_polymul  (fused_ops.py:213, pallas_call :260)
//   keygen_fused  (fused_ops.py:137, pallas_call :174)
//   encrypt_fused (fused_ops.py:466, pallas_call :541)
//   encrypt_front (fused_ops.py:301, pallas_call :337): encrypt_fused's
//                 transform with no e, c[h] = INTT(NTT(u) . pk_h)
// and of ntt_cuda_tpu/ops/bfv_tail.py:
//   encrypt_tail_padded (bfv_tail.py:760, pallas_call :794): encrypt_fused's
//                 tail on one rank's rows, ra from its own all-reduced input;
//                 with no e and no message it is also the sharded key
//                 switch's modulus drop (ntt_drop_last_padded)
//   encrypt_tail (bfv_tail.py:144, pallas_call :175; kernel 14): the same
//                 tail with e added from its own (2, r, n) input and ra from
//                 the last residue of c +> e (ntt_encrypt_tail_e)
// The dyadic products are one Montgomery REDC each; the 2^-64 and the
// inverse's n^-1 cancel in one Shoup multiply by n^-1 * 2^64 at the end.
//
// K3 and K4 (half_polymul, keygen_fused), n <= 2^14: each block owns one
// polynomial (message x modulus).  It stays in dynamic shared memory while
// the forward -> dyadic -> inverse chain runs in place (ntt_block.cuh's
// loop).  n = 2^15 (256 KB, over a block's 227 KB): the reference's hybrid
// schedule.  One launch of two blocks per polynomial runs the op's whole
// in-block chain on its 2^14 half: forward stages 1..14, the dyadic
// product, inverse GS stages 14..1 (ntt_block.cuh's sub-range form,
// tw_mul = 2 + h).  The cross-half butterflies run as elementwise launches
// beside it: CT stage 0 (pairs i, i + n/2, psi[1]) after the op's
// prologue, and GS stage 0 (psi^-1[1]) before the n^-1 Shoup and the op's
// epilogue:
//   half_polymul   CT0(x) | halves | GS0, n^-1
//   keygen_fused   CT0(s) | halves: sk; a . sk, GS 14..1
//                  | GS0, n^-1, -(x + e), CT0 | forward halves: pk0
// Bound on the card: shared memory, 8n bytes per block (128 KB at
// n = 16384 and per half at 2^15: one block per SM, r J of the 132 SMs,
// 2 r J at 2^15), and log n barriers per transform; at 2^15 each stage-0
// pass is a round trip of device memory.  (ROADMAP.md Queue 0: the
// cluster schedule below would make each one launch.)
//
// K5's transform and kernel 18 (encrypt_fused, encrypt_front), every
// n <= 2^15 in one launch: the stage kernels' cluster schedule
// (ntt_cluster.cuh, ntt_stage.cu).  One polynomial p = j r + mi of u
// (message j, modulus mi) per cluster of B = 2^cl blocks, J r B blocks;
// block b holds coefficients [b n/B, (b + 1) n/B) in two buffers s0, s1
// of n/B u64 (64 KB at 2^15, B = 8; B <= 2 at 2^15 and B = 1 at 2^14 do
// not fit, and the launchers refuse them):
//   A. the cluster's threads split the n/B columns: a thread reads column
//      i's B values of u (small_res, i + k n/B), runs CT stages 0..cl-1 on
//      them in registers and writes value k into block k's s0 through
//      distributed shared memory (a cluster barrier before, so that every
//      block has started, and after);
//   B. each block runs its local forward stages (ntt_fwd_tiled, tw_mul =
//      B + b): s0 is its range of NTT(u); s1 = NTT(u) pk1 and s0 =
//      NTT(u) pk0; then the local GS stages of both products in one tiled
//      pass, each twiddle and Shoup companion loaded once for the two
//      butterflies (faster on the card than the two in turn: PERF.md,
//      chip_smoke.py's LOCAL_AB_SRC); a cluster barrier;
//   C. for each product h, a thread gathers column i's B values from the
//      cluster, runs GS stages cl-1..0 in registers, the n^-1 Shoup and
//      +> e_{2j+h} (K5; the strict `>`), into slot (j, h, mi) of the
//      (J, 2, r, n) scratch; a last cluster barrier keeps every block's
//      shared memory until its peers have read it.
// B: stage_cluster_log with two buffers a block, 8 wherever it fits; the
// launcher (run_cluster) raises the shared memory limit to the shape's
// need and checks the cluster's fit once per kernel, device and shape,
// and returns the CUDA error where it does not: there is no two-halves,
// one-block or plain schedule behind it.  Bound on the card: the latency
// of a block's local stages, as the stage kernels' (PERF.md); device
// memory is read once (u, pk, e, the tables) and the scratch written once.
//
// encrypt_fused cannot carry the last residue across grid steps as the TPU
// grid does (fused_ops.py:397-407): blocks run in no order.  Its transform
// writes c_h +> e_h for all r moduli to a (J, 2, r, n) scratch, and an
// elementwise tail launch does the modulus drop and Delta*m + fix.  The
// encrypt tails are elementwise, one thread per output coefficient, bound
// by device memory (the padded tail reads c, e, ra and m once and writes
// ct once: 8 (6 rl + 3) bytes per coefficient of m).  Every op reads
// compact i32 draws (the ternary u and s, the Gaussian e) instead of
// (r, n) u64 residues.
//
// K3 and K4 are structs of their arguments with `block` (one block's work,
// `tid`/`nt` its thread and thread count), `first` and `last` (pair k of
// the 2^15 stage-0 passes); the encrypt transform is a struct with the
// three cluster phases.  The same structs run as CUDA launches or, in the
// host build of the tests, as loops with one thread per block.

#include "ntt_cluster.cuh"

#ifndef __CUDACC__
#include <vector>
#define OP_HD
#else
#define OP_HD __host__ __device__
#endif

// Where block b of a launch works: polynomial p and, at 2^15, half h of it.
struct BlockAt {
  int p, h, logb, nb, tw_mul;
  size_t hoff;  // the block's first coefficient within its polynomial
  size_t off;   // ... within a (P, n) array
};

NTT_HD BlockAt block_at(int b, int logn) {
  const int split = logn > LOG_BLOCK_MAX;
  BlockAt a;
  a.p = b >> split;
  a.h = b & split;
  a.logb = logn - split;
  a.nb = 1 << a.logb;
  a.tw_mul = split ? 2 + a.h : 1;
  a.hoff = (size_t)a.h * a.nb;
  a.off = ((size_t)a.p << logn) + a.hoff;
  return a;
}

// Pair k of a 2^15 stage-0 pass: polynomial p, coefficient i < n/2 and its
// partner i + half, at lo and lo + half of a (P, n) array.
struct PairAt {
  int p;
  size_t i, half, lo;
};

NTT_HD PairAt pair_at(long long k, int logn) {
  PairAt a;
  a.half = (size_t)1 << (logn - 1);
  a.p = (int)(k / (long long)a.half);
  a.i = (size_t)(k % (long long)a.half);
  a.lo = ((size_t)a.p << logn) + a.i;
  return a;
}

// --- half_polymul: out[p] = INTT(NTT(x[p]) (.) y[p % r]) --------------------

struct HalfPolymul {
  const u64* x;  // (P, n)
  const u64* y;  // (r, n)
  u64* out;      // (P, n)
  Twiddles tw;
  int r, logn;

  OP_HD void block(int b, int tid, int nt, u64* s) const {
    const BlockAt at = block_at(b, logn);
    const bool split = logn > LOG_BLOCK_MAX;
    const int mi = at.p % r;
    const ModConsts c = load_consts(tw.consts, mi);
    const Twiddles t = twiddles_at(tw, mi, 1 << logn);
    const u64* src = split ? out : x;  // 2^15: after CT stage 0
    const u64* yb = y + ((size_t)mi << logn) + at.hoff;
    for (int i = tid; i < at.nb; i += nt) s[i] = src[at.off + i];
    ntt_fwd_block(s, at.logb, t, c.q, tid, nt, at.tw_mul);
    for (int i = tid; i < at.nb; i += nt)
      s[i] = mont_mul(s[i], yb[i], c.q, c.qinv);
    ntt_inv_block(s, at.logb, t, c.q, tid, nt, at.tw_mul);
    for (int i = tid; i < at.nb; i += nt)
      out[at.off + i] = split ? s[i] : mul_shoup(s[i], c.ninv, c.ninv_sh, c.q);
  }

  OP_HD void first(long long k) const {
    const PairAt pa = pair_at(k, logn);
    const int mi = pa.p % r;
    const Twiddles t = twiddles_at(tw, mi, 1 << logn);
    u64 a = x[pa.lo], b = x[pa.lo + pa.half];
    ct_butterfly(a, b, t.psi[1], t.psi_sh[1], load_consts(tw.consts, mi).q);
    out[pa.lo] = a;
    out[pa.lo + pa.half] = b;
  }

  OP_HD void last(long long k) const {
    const PairAt pa = pair_at(k, logn);
    const int mi = pa.p % r;
    const ModConsts c = load_consts(tw.consts, mi);
    const Twiddles t = twiddles_at(tw, mi, 1 << logn);
    u64 a = out[pa.lo], b = out[pa.lo + pa.half];
    gs_butterfly(a, b, t.ipsi[1], t.ipsi_sh[1], c.q);
    out[pa.lo] = mul_shoup(a, c.ninv, c.ninv_sh, c.q);
    out[pa.lo + pa.half] = mul_shoup(b, c.ninv, c.ninv_sh, c.q);
  }
};

// --- keygen_fused: per modulus, sk = NTT(s); pk0 = NTT(-(INTT(a . sk) + e)) --

struct Keygen {
  const int* sb;  // (n,) compact ternary s
  const u64* a;   // (r, n)
  const int* ed;  // (n,) compact Gaussian e
  u64* sk;        // (r, n)
  u64* pk0;       // (r, n)
  Twiddles tw;
  int logn;

  OP_HD void block(int b, int tid, int nt, u64* s) const {
    const BlockAt at = block_at(b, logn);
    const bool split = logn > LOG_BLOCK_MAX;
    const ModConsts c = load_consts(tw.consts, at.p);
    const Twiddles t = twiddles_at(tw, at.p, 1 << logn);
    for (int i = tid; i < at.nb; i += nt)
      s[i] = split ? sk[at.off + i] : small_res(sb[i], c.q);
    ntt_fwd_block(s, at.logb, t, c.q, tid, nt, at.tw_mul);
    for (int i = tid; i < at.nb; i += nt) {
      sk[at.off + i] = s[i];
      s[i] = mont_mul(a[at.off + i], s[i], c.q, c.qinv);
    }
    ntt_inv_block(s, at.logb, t, c.q, tid, nt, at.tw_mul);
    if (split) {  // last() and the forward halves follow
      for (int i = tid; i < at.nb; i += nt) pk0[at.off + i] = s[i];
      return;
    }
    for (int i = tid; i < at.nb; i += nt)
      s[i] = add_neg_mod(mul_shoup(s[i], c.ninv, c.ninv_sh, c.q),
                         small_res(ed[i], c.q), c.q);
    ntt_fwd_block(s, at.logb, t, c.q, tid, nt);
    for (int i = tid; i < at.nb; i += nt) pk0[at.off + i] = s[i];
  }

  OP_HD void first(long long k) const {
    const PairAt pa = pair_at(k, logn);
    const u64 q = load_consts(tw.consts, pa.p).q;
    const Twiddles t = twiddles_at(tw, pa.p, 1 << logn);
    u64 u = small_res(sb[pa.i], q), v = small_res(sb[pa.i + pa.half], q);
    ct_butterfly(u, v, t.psi[1], t.psi_sh[1], q);
    sk[pa.lo] = u;
    sk[pa.lo + pa.half] = v;
  }

  // GS stage 0 of INTT(a . sk), n^-1, -(x + e), then CT stage 0 of pk0.
  OP_HD void last(long long k) const {
    const PairAt pa = pair_at(k, logn);
    const ModConsts c = load_consts(tw.consts, pa.p);
    const Twiddles t = twiddles_at(tw, pa.p, 1 << logn);
    u64 u = pk0[pa.lo], v = pk0[pa.lo + pa.half];
    gs_butterfly(u, v, t.ipsi[1], t.ipsi_sh[1], c.q);
    u = add_neg_mod(mul_shoup(u, c.ninv, c.ninv_sh, c.q),
                    small_res(ed[pa.i], c.q), c.q);
    v = add_neg_mod(mul_shoup(v, c.ninv, c.ninv_sh, c.q),
                    small_res(ed[pa.i + pa.half], c.q), c.q);
    ct_butterfly(u, v, t.psi[1], t.psi_sh[1], c.q);
    pk0[pa.lo] = u;
    pk0[pa.lo + pa.half] = v;
  }
};

// 2^15: forward stages 1..14 of each half of x (P, n), in place after CT
// stage 0 (keygen's second forward).
struct ForwardHalves {
  u64* x;
  Twiddles tw;
  int r, logn;

  OP_HD void block(int b, int tid, int nt, u64* s) const {
    const BlockAt at = block_at(b, logn);
    const int mi = at.p % r;
    const u64 q = load_consts(tw.consts, mi).q;
    for (int i = tid; i < at.nb; i += nt) s[i] = x[at.off + i];
    ntt_fwd_block(s, at.logb, twiddles_at(tw, mi, 1 << logn), q, tid, nt,
                  at.tw_mul);
    for (int i = tid; i < at.nb; i += nt) x[at.off + i] = s[i];
  }
};

// --- encrypt_fused, transform: scratch[j, h, mi] = INTT(NTT(u_j) . pk_h) +> e_jh
// With ed null it is encrypt_front (kernel 18): the products alone.  One
// polynomial p = j r + mi of u per cluster of B = 2^CL blocks (the head of
// the file); block b holds two buffers of n/B points, s0 and s1, at
// s[0, n/B) and s[n/B, 2 n/B).

struct EncryptTransform {
  const int* ub;  // (J, n) compact ternary u
  const u64* pk;  // (2, r, n)
  const int* ed;  // (J, 2, n) compact Gaussian e, or null
  u64* scratch;   // (J, 2, r, n)
  Twiddles tw;
  int r, logn;

  OP_HD u64* slot(int j, int h, int mi) const {
    return scratch + (((size_t)(2 * j + h) * r + mi) << logn);
  }

  // The draw plane of row 2 j + h, or null when there is no e.
  OP_HD const int* e_row(int row) const {
    return ed ? ed + ((size_t)row << logn) : nullptr;
  }

  // x +> e[i] (strict `>`), or x where there is no e.
  static OP_HD u64 plus_e(u64 x, const int* e, size_t i, u64 q) {
    return e ? add_mod_gt(x, small_res(e[i], q), q) : x;
  }

  // Phase A on block b of polynomial p's cluster: the cluster's threads
  // split the n/B columns; column i's B values of u (i + k n/B) through CT
  // stages 0..CL-1 in registers, value k into block k's s0.
  template <int CL>
  OP_HD void phase_a(int p, int b, int tid, int nt, u64* const* peer) const {
    const int nb = 1 << (logn - CL);
    const int mi = p % r;
    const u64 q = load_consts(tw.consts, mi).q;
    const Twiddles t = twiddles_at(tw, mi, 1 << logn);
    const int* u = ub + ((size_t)(p / r) << logn);
    for (int i = b * nt + tid; i < nb; i += nt << CL) {
      u64 v[1 << CL];
#pragma unroll
      for (int k = 0; k < (1 << CL); ++k) v[k] = small_res(u[k * nb + i], q);
      cross_fwd<CL>(v, t, q, 1);
#pragma unroll
      for (int k = 0; k < (1 << CL); ++k) peer[k][i] = v[k];
    }
  }

  // Phase B on block b: its local forward stages leave its range of
  // NTT(u) in s0; then s1 = NTT(u) pk1 and s0 = NTT(u) pk0 (Montgomery)
  // and the local GS stages of both products.
  template <int CL>
  OP_HD void phase_b(int p, int b, int tid, int nt, u64* s) const {
    const int logb = logn - CL, nb = 1 << logb;
    const int mi = p % r, tw_mul = (1 << CL) + b;
    const ModConsts c = load_consts(tw.consts, mi);
    const Twiddles t = twiddles_at(tw, mi, 1 << logn);
    u64* s1 = s + nb;
    ntt_fwd_tiled<STAGE_TILE>(s, logb, t, c.q, tid, nt, tw_mul);
    const size_t off = ((size_t)mi << logn) + (size_t)b * nb;
    const u64* pk0 = pk + off;
    const u64* pk1 = pk + ((size_t)r << logn) + off;
    for (int i = tid; i < nb; i += nt) {
      const u64 x = s[i];
      s1[i] = mont_mul(x, pk1[i], c.q, c.qinv);
      s[i] = mont_mul(x, pk0[i], c.q, c.qinv);
    }
    u64* const both[2] = {s, s1};
    ntt_inv_tiled<STAGE_TILE, 2>(both, logb, t, c.q, tid, nt, tw_mul);
  }

  // Phase C on block b: for each product h, column i's B values gathered
  // from the cluster's s_h, GS stages CL-1..0 in registers, the Shoup
  // multiply by n^-1 2^64 (it cancels the product's 2^-64), +> e_{2j+h},
  // into slot (j, h, mi).
  template <int CL>
  OP_HD void phase_c(int p, int b, int tid, int nt, u64* const* peer) const {
    const int nb = 1 << (logn - CL);
    const int j = p / r, mi = p % r;
    const ModConsts c = load_consts(tw.consts, mi);
    const Twiddles t = twiddles_at(tw, mi, 1 << logn);
    for (int h = 0; h < 2; ++h) {
      u64* out = slot(j, h, mi);
      const int* e = e_row(2 * j + h);
      for (int i = b * nt + tid; i < nb; i += nt << CL) {
        u64 v[1 << CL];
#pragma unroll
        for (int k = 0; k < (1 << CL); ++k) v[k] = peer[k][h * nb + i];
        cross_inv<CL>(v, t, c.q, 1);
#pragma unroll
        for (int k = 0; k < (1 << CL); ++k)
          out[k * nb + i] = plus_e(mul_shoup(v[k], c.ninv, c.ninv_sh, c.q), e,
                                   k * nb + i, c.q);
      }
    }
  }
};

// --- encrypt_fused, tail: the modulus drop and Delta*m + fix --------------
// tc: TailConsts.per_mod rows (q, -q^-1, nu, half_mod, inv_q_last * 2^64,
// q_i / t); one thread per output coefficient of ct (J, 2, rk, n).  With
// m null it is the modulus drop alone: the key switch's last launch
// (divide_and_round_q_last of the accumulated (J, 2, r, n) pair).
//
// Two forms.  encrypt_fused's: scratch holds c +> e over all r = rk + 1
// moduli and ra is its last row, + half mod q_last.  encrypt_tail_padded's
// (kernel 16, one rank of the RNS-sharded program): scratch is the rank's
// c (J, 2, rk, n) with r = rk, e (the same shape) is added here, and ra
// (J, 2, n) arrives ready, all-reduced from the dropped modulus's owner
// ((c_last +> e_last) + half mod q_last; the caller passes half = 0).  The
// rank's padded constants give the dropped modulus's own row, if it holds
// it, half_mod 0, inv_q_last 1 and q_i / t 0: that slot is well defined
// and the caller ignores it.  encrypt_tail's (kernel 14): scratch is c
// (2, r, n) after the inverse with r = rk + 1, e (2, r, n) is added here,
// and ra is the last row of c +> e (strict `>`), + half mod q_last.  The
// TPU kernel's (r-1, 2) grid reads the last residue at every step; here
// each thread reads it for its own coefficient.

struct EncryptTail {
  const u64* scratch;
  const u64* e;   // null, or (J, 2, re, n): the padded form's (re = rk) or
                  // encrypt_tail's (re = r)
  const u64* ra;  // null, or the (J, 2, n) ready ra of the padded form
  const long long* m;
  u64* ct;
  const u64* tc;
  u64 q_last, half, fix_th;
  int r, rk, n, re;

  OP_HD void operator()(long long idx) const {
    const int k = (int)(idx % n);
    long long rest = idx / n;
    const int ki = (int)(rest % rk);
    rest /= rk;
    const int h = (int)(rest % 2);
    const long long j = rest / 2;
    const u64* p = tc + 6 * ki;
    const u64 q = p[0], qinv = p[1], nu = p[2], half_mod = p[3], invq = p[4],
              qi_div_t = p[5];
    const size_t row = (size_t)(2 * j + h);
    u64 sv = scratch[(row * r + ki) * n + k];
    if (e) sv = add_mod_gt(sv, e[(row * re + ki) * n + k], q);
    u64 ra_v;
    if (ra) {
      ra_v = ra[row * n + k];
    } else {
      ra_v = scratch[(row * r + rk) * n + k];
      if (e) ra_v = add_mod_gt(ra_v, e[(row * re + rk) * n + k], q_last);
    }
    ra_v += half;
    if (ra_v >= q_last) ra_v -= q_last;
    u64 tmp = mod_nu(ra_v, q, nu);
    tmp = tmp < half_mod ? tmp + q - half_mod : tmp - half_mod;
    const u64 v = sv < tmp ? sv + q - tmp : sv - tmp;
    u64 out = mont_mul(v, invq, q, qinv);
    if (h == 0 && m) {
      const u64 mm = (u64)m[j * n + k];
      out = mod_nu(out + mm * qi_div_t + (mm >= fix_th ? 1ull : 0ull), q, nu);
    }
    ct[idx] = out;
  }
};

// --- launches ---------------------------------------------------------------

template <typename F>
struct FirstPass {
  F f;
  OP_HD void operator()(long long k) const { f.first(k); }
};

template <typename F>
struct LastPass {
  F f;
  OP_HD void operator()(long long k) const { f.last(k); }
};

#ifdef __CUDACC__

template <typename F>
__global__ void k_blocks(F f) {
  extern __shared__ u64 smem[];
  f.block(blockIdx.x, threadIdx.x, blockDim.x, smem);
}

template <typename F>
__global__ void k_each(F f, long long total) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k < total) f(k);
}

// The encrypt transform: one polynomial of u per cluster of 2^CL blocks,
// two buffers of n/B u64 a block.
template <int CL>
__global__ void __launch_bounds__(1024)
    k_encrypt_cluster(EncryptTransform f) {
  extern __shared__ u64 smem[];
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  const int b = (int)cluster.block_rank(), p = (int)(blockIdx.x >> CL);
  u64* peer[1 << CL];
#pragma unroll
  for (int k = 0; k < (1 << CL); ++k)
    peer[k] = cluster.map_shared_rank(smem, k);
  cluster.sync();  // every block of the cluster has started
  f.phase_a<CL>(p, b, threadIdx.x, blockDim.x, peer);
  cluster.sync();  // NTT(u)'s cross stages are in every block
  f.phase_b<CL>(p, b, threadIdx.x, blockDim.x, smem);
  cluster.sync();  // every block's local inverse stages are done
  f.phase_c<CL>(p, b, threadIdx.x, blockDim.x, peer);
  cluster.sync();  // no block exits while another reads its shared memory
}

template <int CL>
static int run_encrypt(const EncryptTransform& f, int P, void* stream) {
  return run_cluster<CL>(k_encrypt_cluster<CL>, P, f.logn, 2, stream, f);
}

// `blocks` blocks of f, each with 2^logb u64 of shared memory.
template <typename F>
static int run_blocks(const F& f, int blocks, int logb, void* stream) {
  return launch_poly(k_blocks<F>, blocks, logb, stream, f);
}

// f(k) for k < total, one thread each.
template <typename F>
static int run_each(const F& f, long long total, void* stream) {
  if (total < 1) return NTT_EINVAL;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  k_each<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(f, total);
  return (int)cudaGetLastError();
}

#else  // host build for the CPU tests: one thread per block, blocks in order

template <typename F>
static int run_blocks(const F& f, int blocks, int logb, void*) {
  if (logb < 1 || logb > LOG_BLOCK_MAX || blocks < 1) return NTT_EINVAL;
  std::vector<u64> s((size_t)1 << logb);
  for (int b = 0; b < blocks; ++b) f.block(b, 0, 1, s.data());
  return 0;
}

template <typename F>
static int run_each(const F& f, long long total, void*) {
  if (total < 1) return NTT_EINVAL;
  for (long long k = 0; k < total; ++k) f(k);
  return 0;
}

// The clusters in turn (walk_clusters): phase A of the B blocks, then B,
// then C.
template <int CL>
static int run_encrypt(const EncryptTransform& f, int P, void*) {
  walk_clusters<CL>(P, 3, (size_t)2 << (f.logn - CL),
                    [&](int ph, int p, int b, u64* const* peer) {
                      if (ph == 0) f.phase_a<CL>(p, b, 0, 1, peer);
                      if (ph == 1) f.phase_b<CL>(p, b, 0, 1, peer[b]);
                      if (ph == 2) f.phase_c<CL>(p, b, 0, 1, peer);
                    });
  return 0;
}

#endif

// K3's or K4's op over `polys` polynomials of 2^logn points: one block each
// up to 2^14; at 2^15 CT stage 0 over them, two half blocks each, then GS
// stage 0.
template <typename F>
static int run_op(const F& f, int polys, int logn, void* stream) {
  if (logn < 1 || logn > LOG_BLOCK_MAX + 1 || polys < 1) return NTT_EINVAL;
  const int split = logn > LOG_BLOCK_MAX;
  const long long half = 1ll << (logn - 1);
  int rc = split ? run_each(FirstPass<F>{f}, polys * half, stream) : 0;
  if (rc == 0) rc = run_blocks(f, polys << split, logn - split, stream);
  if (rc == 0 && split) rc = run_each(LastPass<F>{f}, polys * half, stream);
  return rc;
}

extern "C" int ntt_half_polymul(const void* x, const void* y, void* out,
                                const void* psi, const void* psi_sh,
                                const void* ipsi, const void* ipsi_sh,
                                const void* consts, int blocks, int r, int logn,
                                void* stream) {
  if (r < 1 || blocks % r) return NTT_EINVAL;
  const HalfPolymul f = {(const u64*)x, (const u64*)y, (u64*)out,
                         make_tw(psi, psi_sh, ipsi, ipsi_sh, consts), r, logn};
  return run_op(f, blocks, logn, stream);
}

extern "C" int ntt_keygen_fused(const void* sb, const void* a, const void* ed,
                                void* sk, void* pk0, const void* psi,
                                const void* psi_sh, const void* ipsi,
                                const void* ipsi_sh, const void* consts, int r,
                                int logn, void* stream) {
  const Twiddles tw = make_tw(psi, psi_sh, ipsi, ipsi_sh, consts);
  const Keygen f = {(const int*)sb, (const u64*)a, (const int*)ed, (u64*)sk,
                    (u64*)pk0,      tw,            logn};
  const int rc = run_op(f, r, logn, stream);
  if (rc != 0 || logn <= LOG_BLOCK_MAX) return rc;
  const ForwardHalves fh = {(u64*)pk0, tw, r, logn};
  return run_blocks(fh, 2 * r, logn - 1, stream);
}

// The encrypt transform over P = J r polynomials of u at cluster size B
// (0: the rule, stage_cluster_log with two buffers a block), or
// NTT_EINVAL where a cluster of B blocks cannot hold two n/B buffers.
static int encrypt_transform(const EncryptTransform& f, int P, int B,
                             void* stream) {
  typedef int (*Run)(const EncryptTransform&, int, void*);
  static const Run runs[4] = {run_encrypt<0>, run_encrypt<1>, run_encrypt<2>,
                              run_encrypt<3>};
  const int cl = cluster_log(B, f.logn, 2);
  if (f.logn < 1 || f.logn > LOG_BLOCK_MAX + 1 || cl < 0) return NTT_EINVAL;
  return runs[cl](f, P, stream);
}

// K5's transform: u_b (J, n), pk (2, r, n), ed (J, 2, n) -> scratch
// (J, 2, r, n); cluster: B, or 0 for the rule.
extern "C" int ntt_encrypt_transform_cluster(
    const void* ub, const void* pk, const void* ed, void* scratch,
    const void* psi, const void* psi_sh, const void* ipsi,
    const void* ipsi_sh, const void* consts, int J, int r, int logn,
    int cluster, void* stream) {
  if (J < 1 || r < 1) return NTT_EINVAL;
  const EncryptTransform f = {(const int*)ub, (const u64*)pk, (const int*)ed,
                              (u64*)scratch,
                              make_tw(psi, psi_sh, ipsi, ipsi_sh, consts), r,
                              logn};
  return encrypt_transform(f, J * r, cluster, stream);
}

extern "C" int ntt_encrypt_transform(const void* ub, const void* pk,
                                     const void* ed, void* scratch,
                                     const void* psi, const void* psi_sh,
                                     const void* ipsi, const void* ipsi_sh,
                                     const void* consts, int J, int r, int logn,
                                     void* stream) {
  return ntt_encrypt_transform_cluster(ub, pk, ed, scratch, psi, psi_sh, ipsi,
                                       ipsi_sh, consts, J, r, logn, 0, stream);
}

extern "C" int ntt_encrypt_tail(const void* scratch, const void* m, void* ct,
                                const void* tc, u64 q_last, u64 half,
                                u64 fix_th, int J, int r, int n, void* stream) {
  if (r < 2) return NTT_EINVAL;
  const EncryptTail f = {(const u64*)scratch, nullptr, nullptr,
                         (const long long*)m, (u64*)ct, (const u64*)tc,
                         q_last, half, fix_th, r, r - 1, n, 0};
  return run_each(f, (long long)J * 2 * (r - 1) * n, stream);
}

// Kernel 14: c and e (2, r, n), m (n,) -> ct (2, r-1, n).
extern "C" int ntt_encrypt_tail_e(const void* c, const void* e, const void* m,
                                  void* ct, const void* tc, u64 q_last,
                                  u64 half, u64 fix_th, int r, int n,
                                  void* stream) {
  if (r < 2 || !e) return NTT_EINVAL;
  const EncryptTail f = {(const u64*)c, (const u64*)e, nullptr,
                         (const long long*)m, (u64*)ct, (const u64*)tc,
                         q_last, half, fix_th, r, r - 1, n, r};
  return run_each(f, 2LL * (r - 1) * n, stream);
}

// Kernel 18: c (2, r, n) = INTT(NTT(u) . pk_h) for one message, NTT(u)
// computed once per modulus (the transform above with no e); cluster as
// ntt_encrypt_transform_cluster's.
extern "C" int ntt_encrypt_front_cluster(const void* ub, const void* pk,
                                         void* c, const void* psi,
                                         const void* psi_sh, const void* ipsi,
                                         const void* ipsi_sh,
                                         const void* consts, int r, int logn,
                                         int cluster, void* stream) {
  if (r < 1) return NTT_EINVAL;
  const EncryptTransform f = {(const int*)ub, (const u64*)pk, nullptr, (u64*)c,
                              make_tw(psi, psi_sh, ipsi, ipsi_sh, consts), r,
                              logn};
  return encrypt_transform(f, r, cluster, stream);
}

extern "C" int ntt_encrypt_front(const void* ub, const void* pk, void* c,
                                 const void* psi, const void* psi_sh,
                                 const void* ipsi, const void* ipsi_sh,
                                 const void* consts, int r, int logn,
                                 void* stream) {
  return ntt_encrypt_front_cluster(ub, pk, c, psi, psi_sh, ipsi, ipsi_sh,
                                   consts, r, logn, 0, stream);
}

// Kernel 16: one rank's padded tail, c and e (2, rl, n), ra (2, n) ready,
// m (n,) -> ct (2, rl, n).
extern "C" int ntt_encrypt_tail_padded(const void* c, const void* e,
                                       const void* ra, const void* m, void* ct,
                                       const void* tc, u64 q_last, u64 fix_th,
                                       int rl, int n, void* stream) {
  if (rl < 1 || !e || !ra) return NTT_EINVAL;
  const EncryptTail f = {(const u64*)c, (const u64*)e, (const u64*)ra,
                         (const long long*)m, (u64*)ct, (const u64*)tc,
                         q_last, 0, fix_th, rl, rl, n, rl};
  return run_each(f, 2LL * rl * n, stream);
}

// Kernel 16's tail with no e and no message: the sharded key switch's
// modulus drop (parallel/spmd_mult.py) of one rank's accumulators c
// (2, rl, n) from the all-reduced ra (2, n) -> ct (2, rl, n).
extern "C" int ntt_drop_last_padded(const void* c, const void* ra, void* ct,
                                    const void* tc, u64 q_last, int rl, int n,
                                    void* stream) {
  if (rl < 1 || !ra) return NTT_EINVAL;
  const EncryptTail f = {(const u64*)c, nullptr,  (const u64*)ra,
                         nullptr,       (u64*)ct, (const u64*)tc,
                         q_last,        0,        0,
                         rl,            rl,       n,
                         0};
  return run_each(f, 2LL * rl * n, stream);
}
