// BEHZ fast base conversions of EvalMult: k at compile time, each target
// one exact 128-bit sum reduced once, the targets of one coefficient
// spread over a group of G = 1 or 2 threads.
//
// Replace the three TPU kernels of ntt_cuda_tpu/ops/behz_pallas.py, all
// launched through one pallas_call (_run, behz_pallas.py:315, call :339):
//   21a rns_to_bsk  (_make_rns_to_bsk_kernel, :183): q -> Bsk + sm_mrq
//   21b fast_floor  (_make_fast_floor_kernel, :227): floor(t x / q) in Bsk
//   21c bsk_to_q    (_make_bsk_to_q_kernel,   :258): Shenoy-Kumaresan
// and scale_and_round (behz_pallas.py:406, 21b then 21c) in one launch.
// The TPU grid walks (component, target modulus) in order and parks the
// prescaled source residues in VMEM scratch at the first target step.
//
// Bound on the card: the integer multiplier's instructions (a Shoup
// product and an add_mod a term are about 26; memory and occupancy are
// not the limit, PERF.md).  So every target is one linear form over the k
// prescaled residues and one more input, sum_j x_j c_j + e c_e mod m:
// the constants fold every per-target multiply of the TPU chain (m_tilde^-1,
// prod(q)^-1, t, the Shenoy-Kumaresan correction, and scale_and_round's
// (B/b_t)^-1) into the banks, and the k+1 products (each below 2^122) are
// summed exactly in 128 bits and reduced once (Lin): about 12
// instructions a term.  chip_smoke.py computes the bound per call.
//
// Schedule (k_behz<K, WHICH, SHARE>, instantiated for every k = 1..16):
// a block of BEHZ_THREADS threads holds cb = BEHZ_THREADS / G
// coefficients of one component (grid (n / cb, C)); thread tid is member
// g = tid / cb of coefficient cl = tid % cb, so every warp is one member
// of 32 consecutive coefficients (coalesced, and its targets are
// warp-uniform).  Steps, split by block barriers:
//   0. stage the banks the block reads (the band's rows alone) in shared
//      memory;
//   1. (SHARE) member g prescales the source residues j = g, g + G, ...
//      into a (k, cb) shared exchange (21c also sums its part of alpha,
//      the member of j = k adding the m_sk residue's term);
//   2. each member holds the k prescaled residues in registers (K is a
//      template constant: the array stays in registers, the sums unroll)
//      and computes its targets t = g, g + G, ...
// Without SHARE (the launchers take it at G = 1) each thread prescales
// its sources itself and no exchange or second barrier is needed.
// scale_and_round runs 21b over all k+1 Bsk targets, each straight into
// 21c's prescaled residue (the (B/b_t)^-1 folded in; in registers at G =
// 1, else through a second exchange), and then 21c's step 2: the Bsk
// intermediate never reaches device memory.
// The launchers' G: 1 from 2^16 coefficients a launch (the grid then
// fills the card), else 2; canonical Shoup sums, larger G and the exchange
// at G = 1 all measured slower (tools/behz_ab.py; PERF.md §6).
//
// Band form: the same kernels for target rows [row0, row0 + rl) alone
// replace behz_pallas.py's rns_to_bsk_rows (:431), fast_floor_rows (:447)
// and bsk_to_q_rows (:464), all through _run's pallas_call (:339): one rank
// of the RNS-sharded EvalMult (parallel/spmd_mult.py) gathers every source
// row and computes its own band of targets.  out (and fast_floor's xb) hold
// rl rows; the targets index the banks at t in [row0, row0 + rl).
// bsk_to_q's target k is the padded layout's dropped-modulus slot and
// writes 0.  The full conversions are row0 = 0, rl = k + 1 (k for
// bsk_to_q and scale_and_round).
//
// Outputs are canonical, so they equal ops/behz.py's Montgomery chains
// exactly, whatever G.
//
// Banks (u64; "w, ws" = a constant and its Shoup companion floor(w 2^64 /
// m); "red m" = 2^64 mod m as w, ws, then floor(2^64 / m); "/x" = times
// x^-1; every matrix row a (w, ws) pair per source j):
//   qsrc (k, 6):       q_j; m_tilde / (q/q_j) w, ws; t / (q/q_j) w, ws;
//                      (q/q_j) mod m_tilde
//   tgt  (k+1, 12):    m; prod(q) / m_tilde w, ws; t / prod(q) w, ws;
//                      t / (prod(q) (B/b_t)) w, ws (0 at t = k); red m; 0
//   amat (3, k+1, k, 2): (q/q_j) / m_tilde; -(q/q_j) / prod(q);
//                      -(q/q_j) / (prod(q) (B/b_t)) (row k 0), all mod m
//   bsrc (k, 5):       b_j; 1 / (B/b_j) w, ws (mod b_j);
//                      (B/b_j) / prod(B) mod m_sk w, ws
//   bmat (k, k, 2):    (B/b_j) mod q_t
//   bfin (k, 8):       prod(B) w, ws; -prod(B) w, ws; red q_t; 0
//   glob (8):          m_sk; m_sk >> 1; -1 / prod(B) mod m_sk w, ws;
//                      red m_sk; -(prod q)^-1 mod m_tilde

#include "modarith.cuh"

#ifndef __CUDACC__
#include <vector>
#endif

#ifdef __CUDACC__
#define BEHZ_HD __host__ __device__ __forceinline__
#else
#define BEHZ_HD inline
#endif

#define BEHZ_MAX_K 16
#define BEHZ_THREADS 256
#define BEHZ_LOG_THREADS 8
#define BEHZ_MAX_GROUP 2

enum {
  BEHZ_RNS_TO_BSK = 0,
  BEHZ_FAST_FLOOR = 1,
  BEHZ_BSK_TO_Q = 2,
  BEHZ_SCALE_AND_ROUND = 3
};

struct BehzIO {
  const u64* x;    // (C, k or k+1, n) source residues
  const u64* xb;   // (C, rl, n) fast_floor's Bsk rows ((C, k+1, n) for
                   // scale_and_round), else null
  u64* out;        // (C, rl, n): target rows [row0, row0 + rl)
  const u64* __restrict__ qsrc;
  const u64* __restrict__ tgt;
  const u64* __restrict__ amat;
  const u64* __restrict__ bsrc;
  const u64* __restrict__ bmat;
  const u64* __restrict__ bfin;
  const u64* __restrict__ glob;
  int k, n, row0, rl, lg;  // lg: log2 of the group size G
};

typedef unsigned __int128 u128;

// A linear form sum_i x_i w_i mod m over inputs x_i < 2^61 and constants
// (w, ws) < m < 2^61, at most 17 terms: the exact 128-bit sum, reduced
// once as hi (2^64 mod m) + lo mod m (red m).
struct Lin {
  u128 s = 0;
  BEHZ_HD void add(u64 x, const u64* c) { s += (u128)x * c[0]; }
  BEHZ_HD u64 mod(u64 m, const u64* red) const {
    return add_mod(mul_shoup((u64)(s >> 64), red[0], red[1], m),
                   mod_nu((u64)s, m, red[2]), m);
  }
};

// sum_j x_j row[j] + e ce mod m: row holds K (w, ws) pairs.
template <int K>
NTT_HD u64 lin(const u64 (&x)[K], const u64* row, u64 e, const u64* ce,
               u64 m, const u64* red) {
  Lin acc;
#pragma unroll
  for (int j = 0; j < K; ++j) acc.add(x[j], row + 2 * j);
  acc.add(e, ce);
  return acc.mod(m, red);
}

// Word offsets of one block's shared memory: the staged banks, then (with
// the exchange) the (k, cb) prescaled residues z, 21c's G partial alpha
// sums and scale_and_round's second (k, cb) exchange xp.  Every region
// starts on an even word.
struct BehzSm {
  int qsrc, tgt, amat, bsrc, bfin, bmat, glob, z, part, xp, words;
};

template <int K>
NTT_HD BehzSm behz_sm(int which, bool share, int rl, int cb, int G) {
  const bool q2b = which != BEHZ_BSK_TO_Q;
  const bool b2q = which == BEHZ_BSK_TO_Q || which == BEHZ_SCALE_AND_ROUND;
  const bool fused = which == BEHZ_SCALE_AND_ROUND;
  const int nb = fused ? K + 1 : rl;  // Bsk targets
  const int nq = fused ? K : rl;      // q targets
  BehzSm s;
  int w = 0;
  s.qsrc = w, w += q2b ? 6 * K : 0;
  s.tgt = w, w += q2b ? 12 * nb : 0;
  s.amat = w, w += q2b ? 2 * K * nb : 0;
  s.bsrc = w, w += b2q ? 6 * K : 0;
  s.bfin = w, w += b2q ? 8 * nq : 0;
  s.bmat = w, w += b2q ? 2 * K * nq : 0;
  s.glob = w, w += 8;
  s.z = w, w += share ? K * cb : 0;
  s.part = w, w += share && b2q ? G * cb : 0;
  s.xp = w, w += share && fused ? K * cb : 0;
  s.words = w;
  return s;
}

// One thread's place: member g of G of coefficient i (cl within the
// block's cb) of component c.
struct BehzThr {
  int g, G, cl, cb, c, i;
  bool live;
};

NTT_HD BehzThr behz_thread(const BehzIO& io, int tid, int bx, int c) {
  BehzThr th;
  th.G = 1 << io.lg;
  th.cb = BEHZ_THREADS >> io.lg;
  th.g = tid >> (BEHZ_LOG_THREADS - io.lg);
  th.cl = tid & (th.cb - 1);
  th.c = c;
  th.i = bx * th.cb + th.cl;
  th.live = th.i < io.n;
  return th;
}

// Step 0: the banks this conversion (and band) reads, into shared memory:
// per Bsk target its tgt row and the amat row of its form (21a: amat[0];
// 21b: amat[1]; scale_and_round: amat[2] and tgt's (B/b_t)-folded pair
// for t < k, amat[1] for t = k); per q target its q_t, bfin row and bmat
// row (0 at the pad target t = k).
template <int K, int WHICH>
NTT_HD void behz_stage(const BehzIO& io, u64* sm, const BehzSm& L, int tid) {
  const int T = BEHZ_THREADS;
  const bool fused = WHICH == BEHZ_SCALE_AND_ROUND;
  const size_t plane = (size_t)(K + 1) * K * 2;  // one amat form
  if (WHICH != BEHZ_BSK_TO_Q) {
    const int r0 = fused ? 0 : io.row0, nb = fused ? K + 1 : io.rl;
    for (int w = tid; w < 6 * K; w += T) sm[L.qsrc + w] = io.qsrc[w];
    for (int w = tid; w < 12 * nb; w += T) {
      const int t = r0 + w / 12, col = w % 12;
      // scale_and_round reads the xb pair at cols 3, 4: (B/b_t)-folded
      // below k
      const bool swap = fused && t < K && (col == 3 || col == 4);
      sm[L.tgt + w] = io.tgt[12 * t + col + (swap ? 2 : 0)];
    }
    for (int w = tid; w < 2 * K * nb; w += T) {
      const int t = r0 + w / (2 * K);
      const int form = WHICH == BEHZ_RNS_TO_BSK ? 0 : fused && t < K ? 2 : 1;
      sm[L.amat + w] = io.amat[form * plane + 2 * K * r0 + w];
    }
  }
  if (WHICH == BEHZ_BSK_TO_Q || fused) {
    const int r0 = fused ? 0 : io.row0, nq = fused ? K : io.rl;
    for (int w = tid; w < 5 * K; w += T)
      sm[L.bsrc + 6 * (w / 5) + w % 5] = io.bsrc[w];
    for (int w = tid; w < 8 * nq; w += T) {  // q_t, then bfin's row
      const int t = r0 + w / 8, col = w % 8;
      sm[L.bfin + w] = t >= K ? 0
                       : col == 7 ? io.qsrc[6 * t]
                                  : io.bfin[8 * t + col];
    }
    for (int w = tid; w < 2 * K * nq; w += T)
      sm[L.bmat + w] = r0 + w / (2 * K) < K ? io.bmat[2 * K * r0 + w] : 0;
  }
  for (int w = tid; w < 8; w += T) sm[L.glob + w] = io.glob[w];
}

// A q source prescaled for 21a (m_tilde / (q/q_j)) or 21b (t / (q/q_j)).
template <int WHICH>
NTT_HD u64 q_prescale(u64 v, const u64* s) {
  const int col = WHICH == BEHZ_RNS_TO_BSK ? 1 : 3;
  return mul_shoup(v, s[col], s[col + 1], s[0]);
}

// Step 1 (SHARE): member g prescales sources j = g, g + G, ... into the
// exchange; for 21c (B sources, 1 / (B/b_j)) also its part of alpha's
// form, the member of j = k adding the m_sk residue's term.
template <int K, int WHICH>
NTT_HD void behz_sources(const BehzIO& io, u64* sm, const BehzSm& L,
                         const BehzThr& th) {
  const size_t n = io.n;
  if (WHICH == BEHZ_BSK_TO_Q) {
    const u64* gl = sm + L.glob;
    const u64 msk = gl[0];
    const u64* x = io.x + (size_t)th.c * (K + 1) * n + th.i;
    Lin part;
    for (int j = th.g; j <= K; j += th.G) {
      const u64 v = th.live ? x[j * n] : 0;
      if (j == K) {
        part.add(v, gl + 2);
        break;
      }
      const u64* s = sm + L.bsrc + 6 * j;
      const u64 xp = mul_shoup(v, s[1], s[2], s[0]);
      sm[L.z + j * th.cb + th.cl] = xp;
      part.add(xp, s + 3);
    }
    sm[L.part + th.g * th.cb + th.cl] = part.mod(msk, gl + 4);
  } else {
    const u64* x = io.x + (size_t)th.c * K * n + th.i;
    for (int j = th.g; j < K; j += th.G)
      sm[L.z + j * th.cb + th.cl] =
          q_prescale<WHICH>(th.live ? x[j * n] : 0, sm + L.qsrc + 6 * j);
  }
}

// The k prescaled residues of this thread's coefficient, in registers:
// from the exchange at `off` (SHARE), or prescaled here from x.
template <int K, int WHICH, bool SHARE>
NTT_HD void behz_zp(const BehzIO& io, const u64* sm, const BehzSm& L,
                    const BehzThr& th, int off, u64 (&z)[K]) {
  if (SHARE) {
#pragma unroll
    for (int j = 0; j < K; ++j) z[j] = sm[off + j * th.cb + th.cl];
    return;
  }
  const size_t n = io.n;
  if (WHICH == BEHZ_BSK_TO_Q) {
    const u64* x = io.x + (size_t)th.c * (K + 1) * n + th.i;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const u64* s = sm + L.bsrc + 6 * j;
      z[j] = mul_shoup(th.live ? x[j * n] : 0, s[1], s[2], s[0]);
    }
  } else {
    const u64* x = io.x + (size_t)th.c * K * n + th.i;
#pragma unroll
    for (int j = 0; j < K; ++j)
      z[j] = q_prescale<WHICH>(th.live ? x[j * n] : 0, sm + L.qsrc + 6 * j);
  }
}

// 21c's targets from the prescaled residues xp and alpha (negative when
// alpha > m_sk / 2, strict): out_t = sum_j xp_j (B/b_j) +/- |alpha|
// prod(B) mod q_t for t = row0 + b, b = g, g + G, ... < nq, and 0 at the
// pad target t = k.
template <int K>
NTT_HD void behz_round_out(const BehzIO& io, const u64* sm, const BehzSm& L,
                           const BehzThr& th, const u64 (&xp)[K], u64 alpha,
                           int row0, int nq) {
  const u64* gl = sm + L.glob;
  const bool neg = alpha > gl[1];
  const u64 mag = neg ? gl[0] - alpha : alpha;
  if (!th.live) return;
  u64* o = io.out + (size_t)th.c * nq * io.n + th.i;
  for (int b = th.g; b < nq; b += th.G) {
    const u64* f = sm + L.bfin + 8 * b;  // 0 in the pad row
    o[(size_t)b * io.n] =
        row0 + b == K ? 0
                      : lin<K>(xp, sm + L.bmat + 2 * K * b, mag,
                               f + (neg ? 0 : 2), f[7], f + 4);
  }
}

// 21c's step 2: the prescaled residues xp (from the exchange at `off` with
// alpha's parts, or here) and alpha = sum_j xp_j (B/b_j) / prod(B) -
// x_msk / prod(B) mod m_sk, then the member's targets.
template <int K, bool SHARE>
NTT_HD void behz_round(const BehzIO& io, const u64* sm, const BehzSm& L,
                       const BehzThr& th, int off, int row0, int nq) {
  u64 xp[K];
  behz_zp<K, BEHZ_BSK_TO_Q, SHARE>(io, sm, L, th, off, xp);
  const u64* gl = sm + L.glob;
  const u64 msk = gl[0];
  u64 alpha = 0;
  if (SHARE) {
    for (int h = 0; h < th.G; ++h)
      alpha = add_mod(alpha, sm[L.part + h * th.cb + th.cl], msk);
  } else {
    const u64 xm =
        th.live ? io.x[((size_t)th.c * (K + 1) + K) * io.n + th.i] : 0;
    Lin a;
#pragma unroll
    for (int j = 0; j < K; ++j) a.add(xp[j], sm + L.bsrc + 6 * j + 3);
    a.add(xm, gl + 2);
    alpha = a.mod(msk, gl + 4);
  }
  behz_round_out<K>(io, sm, L, th, xp, alpha, row0, nq);
}

// Step 2 of 21a, 21b and 21c: the member's targets b = g, g + G, ... of
// the band.
template <int K, int WHICH, bool SHARE>
NTT_HD void behz_targets(const BehzIO& io, const u64* sm, const BehzSm& L,
                         const BehzThr& th) {
  if (WHICH == BEHZ_BSK_TO_Q) {
    behz_round<K, SHARE>(io, sm, L, th, L.z, io.row0, io.rl);
    return;
  }
  u64 z[K];
  behz_zp<K, WHICH, SHARE>(io, sm, L, th, L.z, z);
  if (!th.live) return;
  const size_t n = io.n;
  u64* o = io.out + (size_t)th.c * io.rl * n + th.i;
  if (WHICH == BEHZ_RNS_TO_BSK) {
    // q -> Bsk: out = (sum_j z_j (q/q_j) + r prod(q)) / m_tilde, the
    // m_tilde channel u32-wrapping mask arithmetic, sm_mrq's r lifted
    // centered (r >= 2^31 -> r - 2^32 mod m).
    u32 ymt = 0;
#pragma unroll
    for (int j = 0; j < K; ++j) ymt += (u32)z[j] * (u32)sm[L.qsrc + 6 * j + 5];
    const u32 rr = ymt * (u32)sm[L.glob + 7];
    for (int b = th.g; b < io.rl; b += th.G) {
      const u64* g = sm + L.tgt + 12 * b;
      const u64 m = g[0];
      const u64 temp = rr >= (1u << 31) ? (u64)rr + (m - (1ull << 32)) : rr;
      o[b * n] = lin<K>(z, sm + L.amat + 2 * K * b, temp, g + 1, m, g + 7);
    }
  } else {
    // floor(t x / q) in Bsk = (t xb - sum_j z_j (q/q_j)) / prod(q).
    const u64* xb = io.xb + (size_t)th.c * io.rl * n + th.i;
    for (int b = th.g; b < io.rl; b += th.G) {
      const u64* g = sm + L.tgt + 12 * b;
      o[b * n] = lin<K>(z, sm + L.amat + 2 * K * b, xb[b * n], g + 3, g[0],
                        g + 7);
    }
  }
}

// scale_and_round's step 2: the member's Bsk targets t = g, g + G, ... of
// all k+1: below k straight into 21c's prescaled residue xp_t (the
// staged forms carry 1 / (B/b_t)), into the second exchange with its term
// of alpha; at t = k the m_sk floor's term of alpha.
template <int K>
NTT_HD void behz_floors(const BehzIO& io, u64* sm, const BehzSm& L,
                        const BehzThr& th) {
  u64 z[K];
  behz_zp<K, BEHZ_FAST_FLOOR, true>(io, sm, L, th, L.z, z);
  const size_t n = io.n;
  const u64* gl = sm + L.glob;
  const u64 msk = gl[0];
  const u64* xb = io.xb + (size_t)th.c * (K + 1) * n + th.i;
  Lin part;
  for (int t = th.g; t <= K; t += th.G) {
    const u64* g = sm + L.tgt + 12 * t;
    const u64 v = lin<K>(z, sm + L.amat + 2 * K * t, th.live ? xb[t * n] : 0,
                         g + 3, g[0], g + 7);
    if (t == K) {
      part.add(v, gl + 2);
      break;
    }
    sm[L.xp + t * th.cb + th.cl] = v;
    part.add(v, sm + L.bsrc + 6 * t + 3);
  }
  sm[L.part + th.g * th.cb + th.cl] = part.mod(msk, gl + 4);
}

// scale_and_round with one thread a coefficient (no exchange): the k+1
// floors, each below k straight into xp_t, alpha's form and 21c's targets,
// all in registers.
template <int K>
NTT_HD void behz_scale_round(const BehzIO& io, const u64* sm, const BehzSm& L,
                             const BehzThr& th) {
  u64 z[K], xp[K];
  behz_zp<K, BEHZ_FAST_FLOOR, false>(io, sm, L, th, L.z, z);
  const size_t n = io.n;
  const u64* gl = sm + L.glob;
  const u64 msk = gl[0];
  const u64* xb = io.xb + (size_t)th.c * (K + 1) * n + th.i;
  Lin a;
#pragma unroll
  for (int t = 0; t <= K; ++t) {
    const u64* g = sm + L.tgt + 12 * t;
    const u64 v = lin<K>(z, sm + L.amat + 2 * K * t, th.live ? xb[t * n] : 0,
                         g + 3, g[0], g + 7);
    if (t < K) xp[t] = v;
    a.add(v, t < K ? sm + L.bsrc + 6 * t + 3 : gl + 2);
  }
  behz_round_out<K>(io, sm, L, th, xp, a.mod(msk, gl + 4), 0, K);
}

// Targets: Bsk's k + 1 rows, or q's k rows and the pad slot k;
// scale_and_round the whole of q.  G a power of two up to
// BEHZ_MAX_GROUP (lg), at most 65535 components.
static bool behz_args_ok(int which, const void* xb, int C, int k, int n,
                         int row0, int rl, int lg) {
  return which >= BEHZ_RNS_TO_BSK && which <= BEHZ_SCALE_AND_ROUND &&
         C >= 1 && C <= 65535 && k >= 1 && k <= BEHZ_MAX_K && n >= 1 &&
         row0 >= 0 && rl >= 1 && row0 + rl <= k + 1 && lg >= 0 &&
         (1 << lg) <= BEHZ_MAX_GROUP &&
         (which != BEHZ_FAST_FLOOR || xb != nullptr) &&
         (which != BEHZ_SCALE_AND_ROUND ||
          (xb != nullptr && row0 == 0 && rl == k));
}

// The group size G by the launchers' rule (group = 0): one thread a
// coefficient from 2^16 coefficients a launch (the grid then fills the
// card), else two (tools/behz_ab.py; PERF.md §6).
static int behz_group_rule(int C, int n) {
  return (long long)C * n >= (1 << 16) ? 1 : 2;
}

static int behz_lg(int group) {
  int lg = 0;
  while ((1 << lg) < group) ++lg;
  return (1 << lg) == group ? lg : -1;
}

static BehzIO behz_io(const void* x, const void* xb, void* out,
                      const void* qsrc, const void* tgt, const void* amat,
                      const void* bsrc, const void* bmat, const void* bfin,
                      const void* glob, int k, int n, int row0, int rl,
                      int lg) {
  BehzIO io = {(const u64*)x,    (const u64*)xb,   (u64*)out,
               (const u64*)qsrc, (const u64*)tgt,  (const u64*)amat,
               (const u64*)bsrc, (const u64*)bmat, (const u64*)bfin,
               (const u64*)glob, k,                n,
               row0,             rl,               lg};
  return io;
}

#ifdef __CUDACC__

template <int K, int WHICH, bool SHARE>
__global__ void __launch_bounds__(BEHZ_THREADS, 2) k_behz(BehzIO io) {
  extern __shared__ __align__(16) u64 behz_smem[];
  const int cb = BEHZ_THREADS >> io.lg;
  const BehzSm L = behz_sm<K>(WHICH, SHARE, io.rl, cb, 1 << io.lg);
  const BehzThr th = behz_thread(io, threadIdx.x, blockIdx.x, blockIdx.y);
  const bool fused = WHICH == BEHZ_SCALE_AND_ROUND;
  behz_stage<K, WHICH>(io, behz_smem, L, threadIdx.x);
  __syncthreads();
  if (SHARE) {
    behz_sources<K, fused ? BEHZ_FAST_FLOOR : WHICH>(io, behz_smem, L, th);
    __syncthreads();
  }
  if (fused && SHARE) {
    behz_floors<K>(io, behz_smem, L, th);
    __syncthreads();
    behz_round<K, true>(io, behz_smem, L, th, L.xp, 0, K);
  } else if (fused) {
    behz_scale_round<K>(io, behz_smem, L, th);
  } else {
    behz_targets<K, WHICH, SHARE>(io, behz_smem, L, th);
  }
}

template <int K, int WHICH, bool SHARE>
static int behz_run(const BehzIO& io, int C, cudaStream_t s) {
  const int cb = BEHZ_THREADS >> io.lg;
  const BehzSm L = behz_sm<K>(WHICH, SHARE, io.rl, cb, 1 << io.lg);
  const size_t bytes = (size_t)L.words * sizeof(u64);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        k_behz<K, WHICH, SHARE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)((io.n + cb - 1) / cb), (unsigned)C);
  k_behz<K, WHICH, SHARE><<<grid, BEHZ_THREADS, bytes, s>>>(io);
  return (int)cudaGetLastError();
}

#else  // host build for the CPU tests: each block's threads step by step

template <int K, int WHICH, bool SHARE>
static int behz_run(const BehzIO& io, int C, void*) {
  const int cb = BEHZ_THREADS >> io.lg, T = BEHZ_THREADS;
  const bool fused = WHICH == BEHZ_SCALE_AND_ROUND;
  const BehzSm L = behz_sm<K>(WHICH, SHARE, io.rl, cb, 1 << io.lg);
  std::vector<u64> smv(L.words);
  u64* sm = smv.data();
  for (int c = 0; c < C; ++c)
    for (int bx = 0; bx < (io.n + cb - 1) / cb; ++bx) {
      for (int tid = 0; tid < T; ++tid) behz_stage<K, WHICH>(io, sm, L, tid);
      if (SHARE)
        for (int tid = 0; tid < T; ++tid)
          behz_sources<K, fused ? BEHZ_FAST_FLOOR : WHICH>(
              io, sm, L, behz_thread(io, tid, bx, c));
      for (int tid = 0; tid < T; ++tid) {
        const BehzThr th = behz_thread(io, tid, bx, c);
        if (fused && SHARE)
          behz_floors<K>(io, sm, L, th);
        else if (fused)
          behz_scale_round<K>(io, sm, L, th);
        else
          behz_targets<K, WHICH, SHARE>(io, sm, L, th);
      }
      if (fused && SHARE)
        for (int tid = 0; tid < T; ++tid)
          behz_round<K, true>(io, sm, L, behz_thread(io, tid, bx, c), L.xp,
                              0, K);
    }
  return 0;
}

#endif

// k (runtime) -> the k_behz<K, ...> instantiation, K = 1..BEHZ_MAX_K.
template <int WHICH, bool SHARE, int K = 1, class S>
static int behz_dispatch(const BehzIO& io, int C, S stream) {
  if (io.k == K) return behz_run<K, WHICH, SHARE>(io, C, stream);
  if constexpr (K < BEHZ_MAX_K)
    return behz_dispatch<WHICH, SHARE, K + 1>(io, C, stream);
  else
    return -1;
}

template <bool SHARE, class S>
static int behz_launch(int which, const BehzIO& io, int C, S stream) {
  switch (which) {
    case BEHZ_RNS_TO_BSK:
      return behz_dispatch<BEHZ_RNS_TO_BSK, SHARE>(io, C, stream);
    case BEHZ_FAST_FLOOR:
      return behz_dispatch<BEHZ_FAST_FLOOR, SHARE>(io, C, stream);
    case BEHZ_BSK_TO_Q:
      return behz_dispatch<BEHZ_BSK_TO_Q, SHARE>(io, C, stream);
    default:
      return behz_dispatch<BEHZ_SCALE_AND_ROUND, SHARE>(io, C, stream);
  }
}

#ifdef __CUDACC__
#define BEHZ_BAD_ARGS ((int)cudaErrorInvalidValue)
typedef cudaStream_t BehzStream;
#else
#define BEHZ_BAD_ARGS 1
typedef void* BehzStream;
#endif

// which: BEHZ_*; x (C, k or k+1, n), xb (C, rl, n) for fast_floor and
// (C, k+1, n) for scale_and_round, out (C, rl, n) for target rows [row0,
// row0 + rl); every bank pointer is passed (a kernel reads its own);
// group: 0 for the launchers' rule, as the library always passes; 1 or 2
// forces G, so that the host tests reach both sides of the rule at small
// shapes.
extern "C" int ntt_behz(int which, const void* x, const void* xb, void* out,
                        const void* qsrc, const void* tgt, const void* amat,
                        const void* bsrc, const void* bmat, const void* bfin,
                        const void* glob, int C, int k, int n, int row0,
                        int rl, int group, void* stream) {
  const int lg = behz_lg(group == 0 ? behz_group_rule(C, n) : group);
  if (!behz_args_ok(which, xb, C, k, n, row0, rl, lg)) return BEHZ_BAD_ARGS;
  const BehzIO io = behz_io(x, xb, out, qsrc, tgt, amat, bsrc, bmat, bfin,
                            glob, k, n, row0, rl, lg);
  // the exchange pays where a coefficient has several members
  return lg > 0 ? behz_launch<true>(which, io, C, (BehzStream)stream)
                : behz_launch<false>(which, io, C, (BehzStream)stream);
}
