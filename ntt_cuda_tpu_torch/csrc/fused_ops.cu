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
// The three transforms (K3, K4, and K5's transform with kernel 18), every
// n <= 2^17 in one launch: the stage kernels' cluster schedule
// (ntt_cluster.cuh, ntt_stage.cu).  One polynomial p per cluster of
// B = 2^cl blocks, P B blocks; block b holds coefficients
// [b n/B, (b + 1) n/B) of it in BUFS buffers of n/B u64 and, after its
// local forward stages, the same range of the NTT in the stage kernels'
// output order (the range of y, a, sk and pk it reads or writes).  A
// kernel is a struct of phases, with a cluster barrier between two:
//   A. the cluster's threads share out the n/B columns: a thread reads column
//      i's B values (coefficients i + k n/B), runs CT stages 0..cl-1 on
//      them in registers and writes value k into block k's buffer through
//      distributed shared memory (a cluster barrier before, so that every
//      block has started);
//   B. each block runs its local forward stages (ntt_fwd_tiled, tw_mul =
//      B + b), the dyadic product(s) on its range, and its local GS stages;
//   C. a thread gathers column i's B values from the cluster, runs GS
//      stages cl-1..0 in registers and the n^-1 Shoup;
//   D. (K4 only) the local forward stages again.
// Per op:
//   half_polymul   P = J r (message, modulus), one buffer: A on x; B
//                  NTT . y[p % r]; C into out[p]
//   keygen_fused   P = r, one buffer: A on s; B writes sk, then a . sk; C
//                  -(x + e) and CT stages 0..cl-1 again, written back to the
//                  slots it read (one thread owns a column: race-free);
//                  D writes pk0
//   encrypt        P = J r (message j, modulus mi of u), two buffers s0,
//                  s1: A on u into s0; B s0 = NTT(u), s1 = NTT(u) pk1 and
//                  s0 = NTT(u) pk0, the local GS stages of both in one
//                  tiled pass, each twiddle and Shoup companion loaded once
//                  for the two butterflies (faster on the card than the two
//                  in turn: PERF.md, chip_smoke.py's LOCAL_AB_SRC); C for
//                  each product h, +> e_{2j+h} (K5; the strict `>`), into
//                  slot (j, h, mi) of the (J, 2, r, n) scratch
// After the last phase that reads a peer's shared memory a cluster barrier
// keeps every block's shared memory until its peers have read it (K4's D
// is local: its barrier is the one before D).
// B: stage_cluster_log with the op's buffers a block, 8 wherever it fits
// (2^15: B >= 2 for one buffer, B >= 4 for two; 2^14: B >= 2 for two; 2^16: B
// >= 4 for one, 8 for two; 2^17: 8 for one), and 16 for the two buffers of
// K5's transform and kernel 18 at 2^17 (two 64 KB buffers a block; a
// non-portable cluster size, allowed on each kernel and checked against the
// card with cudaOccupancyMaxActiveClusters at set-up, as every cluster); the
// launchers refuse a B that does not fit or is no power of two up to 8 (16
// only there).  The launcher (run_cluster) raises the shared memory limit to
// the shape's need and checks the cluster's fit once per kernel, device and
// shape, and returns the CUDA error where it does not: there is no two-halves,
// one-block or plain schedule behind it.  Bound on the card: the latency of a
// block's local stages, as the stage kernels' (PERF.md); device memory is read
// once (x and y; s, a and e; u, pk and e; the tables) and each output written
// once.
//
// encrypt_fused cannot carry the last residue across grid steps as the TPU
// grid does (fused_ops.py:397-407): blocks run in no order.  Its transform
// writes c_h +> e_h for all r moduli to a (J, 2, r, n) scratch, and an
// elementwise tail launch does the modulus drop and Delta*m + fix (the
// encrypt tail, EncryptTail below: G lanes a coefficient and up to five
// output residues a thread, bound by device memory).  Every op reads
// compact i32 draws (the ternary u and s, the Gaussian e) instead of
// (r, n) u64 residues.
//
// The transform structs run as CUDA cluster launches or, in the host build
// of the tests, through walk_clusters with one thread per block.

#include "ntt_cluster.cuh"

#ifndef __CUDACC__
#define OP_HD
#else
#define OP_HD __host__ __device__
#endif

// Phase A's input at coefficient k: a row of residues, or a compact i32
// draw's residue mod q.
struct RowIn {
  const u64* x;
  OP_HD u64 operator()(int k) const { return x[k]; }
};

struct DrawIn {
  const int* d;
  u64 q;
  OP_HD u64 operator()(int k) const { return small_res(d[k], q); }
};

// Phase A's column loop on block b of a cluster of 2^CL blocks: column
// i's 2^CL values value(k n/B + i), CT stages 0..CL-1, value k into
// peer[k][i].
template <int CL, typename V>
OP_HD void cross_in(int logn, int b, int tid, int nt, const Twiddles& t,
                    u64 q, u64* const* peer, V value) {
  const int nb = 1 << (logn - CL);
  for (int i = b * nt + tid; i < nb; i += nt << CL) {
    u64 v[1 << CL];
#pragma unroll
    for (int k = 0; k < (1 << CL); ++k) v[k] = value(k * nb + i);
    cross_fwd<CL>(v, t, q, 1);
#pragma unroll
    for (int k = 0; k < (1 << CL); ++k) peer[k][i] = v[k];
  }
}

// --- half_polymul: out[p] = INTT(NTT(x[p]) (.) y[p % r]) --------------------

struct HalfPolymul {
  static constexpr int PHASES = 3, BUFS = 1;
  const u64* x;  // (P, n)
  const u64* y;  // (r, n)
  u64* out;      // (P, n)
  Twiddles tw;
  int r, logn;

  template <int CL>
  OP_HD void phase_a(int p, int b, int tid, int nt, u64* const* peer) const {
    const int mi = p % r;
    cross_in<CL>(logn, b, tid, nt, twiddles_at(tw, mi, 1 << logn),
                 load_consts(tw.consts, mi).q, peer,
                 RowIn{x + ((size_t)p << logn)});
  }

  // Block b's range of NTT(x[p]) times y's, then the local GS stages.
  template <int CL>
  OP_HD void phase_b(int p, int b, int tid, int nt, u64* s) const {
    const int logb = logn - CL, nb = 1 << logb;
    const int mi = p % r, tw_mul = (1 << CL) + b;
    const ModConsts c = load_consts(tw.consts, mi);
    const Twiddles t = twiddles_at(tw, mi, 1 << logn);
    ntt_fwd_tiled<STAGE_TILE>(s, logb, t, c.q, tid, nt, tw_mul);
    const u64* yb = y + ((size_t)mi << logn) + (size_t)b * nb;
    for (int i = tid; i < nb; i += nt)
      s[i] = mont_mul(s[i], yb[i], c.q, c.qinv);
    ntt_inv_tiled<STAGE_TILE>(s, logb, t, c.q, tid, nt, tw_mul);
  }

  template <int CL>
  OP_HD void phase_c(int p, int b, int tid, int nt, u64* const* peer) const {
    const int nb = 1 << (logn - CL);
    const int mi = p % r;
    const ModConsts c = load_consts(tw.consts, mi);
    const Twiddles t = twiddles_at(tw, mi, 1 << logn);
    u64* op = out + ((size_t)p << logn);
    for (int i = b * nt + tid; i < nb; i += nt << CL) {
      u64 v[1 << CL];
#pragma unroll
      for (int k = 0; k < (1 << CL); ++k) v[k] = peer[k][i];
      cross_inv<CL>(v, t, c.q, 1);
#pragma unroll
      for (int k = 0; k < (1 << CL); ++k)
        op[k * nb + i] = mul_shoup(v[k], c.ninv, c.ninv_sh, c.q);
    }
  }
};

// --- keygen_fused: per modulus, sk = NTT(s); pk0 = NTT(-(INTT(a . sk) + e)) --

struct Keygen {
  static constexpr int PHASES = 4, BUFS = 1;
  const int* sb;  // (n,) compact ternary s
  const u64* a;   // (r, n)
  const int* ed;  // (n,) compact Gaussian e
  u64* sk;        // (r, n)
  u64* pk0;       // (r, n)
  Twiddles tw;
  int logn;

  template <int CL>
  OP_HD void phase_a(int p, int b, int tid, int nt, u64* const* peer) const {
    const u64 q = load_consts(tw.consts, p).q;
    cross_in<CL>(logn, b, tid, nt, twiddles_at(tw, p, 1 << logn), q, peer,
                 DrawIn{sb, q});
  }

  // Block b's range of sk = NTT(s), written out; then a . sk and the
  // local GS stages.
  template <int CL>
  OP_HD void phase_b(int p, int b, int tid, int nt, u64* s) const {
    const int logb = logn - CL, nb = 1 << logb;
    const int tw_mul = (1 << CL) + b;
    const ModConsts c = load_consts(tw.consts, p);
    const Twiddles t = twiddles_at(tw, p, 1 << logn);
    ntt_fwd_tiled<STAGE_TILE>(s, logb, t, c.q, tid, nt, tw_mul);
    const size_t off = ((size_t)p << logn) + (size_t)b * nb;
    for (int i = tid; i < nb; i += nt) {
      sk[off + i] = s[i];
      s[i] = mont_mul(a[off + i], s[i], c.q, c.qinv);
    }
    ntt_inv_tiled<STAGE_TILE>(s, logb, t, c.q, tid, nt, tw_mul);
  }

  // Column i: GS stages CL-1..0, n^-1, -(x + e) with e at coefficient
  // k n/B + i, CT stages 0..CL-1 of the second forward, back to the slots
  // read (all B values are in registers before the first write).
  template <int CL>
  OP_HD void phase_c(int p, int b, int tid, int nt, u64* const* peer) const {
    const int nb = 1 << (logn - CL);
    const ModConsts c = load_consts(tw.consts, p);
    const Twiddles t = twiddles_at(tw, p, 1 << logn);
    for (int i = b * nt + tid; i < nb; i += nt << CL) {
      u64 v[1 << CL];
#pragma unroll
      for (int k = 0; k < (1 << CL); ++k) v[k] = peer[k][i];
      cross_inv<CL>(v, t, c.q, 1);
#pragma unroll
      for (int k = 0; k < (1 << CL); ++k)
        v[k] = add_neg_mod(mul_shoup(v[k], c.ninv, c.ninv_sh, c.q),
                           small_res(ed[k * nb + i], c.q), c.q);
      cross_fwd<CL>(v, t, c.q, 1);
#pragma unroll
      for (int k = 0; k < (1 << CL); ++k) peer[k][i] = v[k];
    }
  }

  // Block b's local forward stages: its range of pk0.
  template <int CL>
  OP_HD void phase_d(int p, int b, int tid, int nt, u64* s) const {
    const int logb = logn - CL, nb = 1 << logb;
    const Twiddles t = twiddles_at(tw, p, 1 << logn);
    ntt_fwd_tiled<STAGE_TILE>(s, logb, t, load_consts(tw.consts, p).q, tid,
                              nt, (1 << CL) + b);
    u64* ob = pk0 + ((size_t)p << logn) + (size_t)b * nb;
    for (int i = tid; i < nb; i += nt) ob[i] = s[i];
  }
};

// --- encrypt_fused, transform: scratch[j, h, mi] = INTT(NTT(u_j) . pk_h) +> e_jh
// With ed null it is encrypt_front (kernel 18): the products alone.  One
// polynomial p = j r + mi of u per cluster (the head of the file); block b
// holds two buffers of n/B points, s0 and s1, at s[0, n/B) and
// s[n/B, 2 n/B).

struct EncryptTransform {
  static constexpr int PHASES = 3, BUFS = 2;
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

  template <int CL>
  OP_HD void phase_a(int p, int b, int tid, int nt, u64* const* peer) const {
    const int mi = p % r;
    const u64 q = load_consts(tw.consts, mi).q;
    cross_in<CL>(logn, b, tid, nt, twiddles_at(tw, mi, 1 << logn), q, peer,
                 DrawIn{ub + ((size_t)(p / r) << logn), q});
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
// ct[j, h, i] = ((c_i - (ra - half mod q_i)) * q_last^-1 mod q_i), plus
// Delta*m + fix for h = 0 where there is a message, over ct (J, 2, rk, n);
// ra = (c_last + half) mod q_last of the same (j, h) and coefficient.  With
// m null it is the modulus drop alone: the key switch's last launch
// (divide_and_round_q_last of the accumulated (J, 2, r, n) pair).  tc:
// the kernel's rows (TailConsts.tail_rows, PaddedTailConsts.tail_rows), q,
// floor(2^64 / q), half_mod, q_last^-1 mod q and q_i // t as Shoup pairs
// (w, floor(w 2^64 / q)), 0.
//
// Five forms, one struct:
//   K5 and 13 (ntt_encrypt_tail): scratch holds c +> e over all r = rk + 1
//     moduli (J, 2, r, n); ra is its last row, + half mod q_last;
//   19's drop (ntt_encrypt_tail with m null): the same over the key
//     switch's accumulators;
//   14 (ntt_encrypt_tail_e): scratch is c (2, r, n) after the inverse, e
//     (2, r, n) is added here (strict `>`), and ra is the last row of
//     c +> e, + half mod q_last;
//   16 (ntt_encrypt_tail_padded, one rank of the RNS-sharded program): c
//     (2, rl, n) with rk = rl, e of the same shape added here, and ra (2, n)
//     arriving ready, all-reduced from the dropped modulus's owner
//     ((c_last +> e_last) + half mod q_last: the launcher passes half 0).
//     The rank's padded rows give the dropped modulus's own row, if it
//     holds it, half_mod 0, q_last^-1 1 and q_i // t 0: that slot is well
//     defined and the caller ignores it;
//   16's drop (ntt_drop_last_padded, the sharded key switch): 16 with no e
//     and no message (the dropped row's inverse 0).
// The TPU kernels carry the last residue across their grid steps or read it
// at every step; here the grid's y is the (j, h) row and x the coefficient:
// thread v takes coefficients k0 .. k0 + V - 1, k0 = V (v / G), and output
// residues g, g + G, ... (at most ROWS, a template constant), g = v mod G,
// with no division of the index.  A thread loads everything first: ra's
// row (and e's last row), each of its rows of c (and e) and m, V adjacent
// words at a time (one 16-byte load at V = 2), then forms ra once for its
// coefficients and reduces it against each of its moduli.  The G lanes of
// a coefficient are adjacent in a warp, so their loads of ra and m are one
// memory access.  The multiply by q_last^-1 and by q_i // t are Shoup
// products by constants (the plain chain's Montgomery product and its
// final Barrett reduction of out + m (q_i // t) + fix give the same
// canonical residues: the message term is below q for m < t).  Bound on
// the card: device memory, each input read once and ct written once (K5 at
// 32k_9q, J = 16: 147 MB).  The rule (et_plan) picks G and V from rk and
// the grid's size; tools/tail_ab.py times the other choices.  The host
// build runs the same partition: each (row, coefficient group, lane) in
// turn.

#define ET_THREADS 128
#define ET_MAX_ROWS 5        // output residues a thread at most
#define ET_WIDE_COEFS (1 << 18)  // coefficients a launch from which V = 2

struct EncryptTail {
  const u64* scratch;  // (J, 2, r, n)
  const u64* e;        // null, or (J, 2, re, n)
  const u64* ra;       // null (the last row of scratch), or (J, 2, n) ready
  const long long* m;  // null, or (J, n)
  u64* ct;             // (J, 2, rk, n)
  const u64* tc;       // (rk, 8) tail rows
  u64 q_last, half, fix_th;
  int r, re, rk, n;
  int lg;              // log2 of G, the lanes a coefficient
};

// V adjacent words at p (16-byte aligned where V = 2 on the card).
template <int V>
OP_HD void load_v(u64 (&v)[V], const u64* p) {
#ifdef __CUDA_ARCH__
  if constexpr (V == 2) {
    const ulonglong2 w = *reinterpret_cast<const ulonglong2*>(p);
    v[0] = w.x;
    v[1] = w.y;
    return;
  }
#endif
  for (int i = 0; i < V; ++i) v[i] = p[i];
}

template <int V>
OP_HD void store_v(u64* p, const u64 (&v)[V]) {
#ifdef __CUDA_ARCH__
  if constexpr (V == 2) {
    *reinterpret_cast<ulonglong2*>(p) = make_ulonglong2(v[0], v[1]);
    return;
  }
#endif
  for (int i = 0; i < V; ++i) p[i] = v[i];
}

// Output residues g, g + G, ... < rk (at most ROWS) of row `row` = 2 j + h
// at coefficients k0 .. k0 + V - 1.
template <int ROWS, int V>
OP_HD void encrypt_tail_coefs(const EncryptTail& f, int row, int k0, int g) {
  const int G = 1 << f.lg;
  const size_t n = f.n, c_row = (size_t)row * f.r * n + k0,
               e_row = (size_t)row * f.re * n + k0;
  const bool e_last = !f.ra && f.e, msg = f.m && !(row & 1);
  u64 ra[V], el[V] = {}, mm[V] = {}, sv[ROWS][V] = {}, ev[ROWS][V] = {};
  load_v<V>(ra, f.ra ? f.ra + (size_t)row * n + k0
                     : f.scratch + c_row + (size_t)f.rk * n);
  if (e_last) load_v<V>(el, f.e + e_row + (size_t)f.rk * n);
#pragma unroll
  for (int u = 0; u < ROWS; ++u) {
    const int i = g + u * G;
    if (i < f.rk) {
      load_v<V>(sv[u], f.scratch + c_row + (size_t)i * n);
      if (f.e) load_v<V>(ev[u], f.e + e_row + (size_t)i * n);
    }
  }
  if (msg) load_v<V>(mm, (const u64*)f.m + (size_t)(row >> 1) * n + k0);
#pragma unroll
  for (int v = 0; v < V; ++v) {
    u64 x = e_last ? add_mod_gt(ra[v], el[v], f.q_last) : ra[v];
    x += f.half;
    ra[v] = x >= f.q_last ? x - f.q_last : x;
  }
#pragma unroll
  for (int u = 0; u < ROWS; ++u) {
    const int i = g + u * G;
    if (i >= f.rk) break;
    const u64* p = f.tc + 8 * i;
    const u64 q = p[0], nu = p[1], half_mod = p[2];
    u64 out[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const u64 s = f.e ? add_mod_gt(sv[u][v], ev[u][v], q) : sv[u][v];
      u64 tmp = mod_nu(ra[v], q, nu);
      tmp = tmp < half_mod ? tmp + q - half_mod : tmp - half_mod;
      u64 o = mul_shoup(s < tmp ? s + q - tmp : s - tmp, p[3], p[4], q);
      if (msg) {
        o = add_mod(o, mul_shoup(mm[v], p[5], p[6], q), q) +
            (mm[v] >= f.fix_th ? 1ull : 0ull);
        if (o >= q) o -= q;
      }
      out[v] = o;
    }
    store_v<V>(f.ct + ((size_t)row * f.rk + i) * n + k0, out);
  }
}

// --- launches ---------------------------------------------------------------

#ifdef __CUDACC__

// The encrypt tail: row blockIdx.y, V coefficients and ROWS residues a
// thread (the struct's head).
template <int ROWS, int V>
__global__ void __launch_bounds__(ET_THREADS) k_encrypt_tail(EncryptTail f) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  const int k0 = (v >> f.lg) * V;
  if (k0 < f.n)
    encrypt_tail_coefs<ROWS, V>(f, blockIdx.y, k0, v & ((1 << f.lg) - 1));
}

// One transform's phases (the head of the file): polynomial blockIdx.x >> CL
// on a cluster of 2^CL blocks, F::BUFS buffers of n/B u64 a block, at
// least OCC blocks an SM (ClusterBound).
template <int CL, int OCC, typename F>
__global__ void __launch_bounds__(ClusterBound<CL, OCC>::threads,
                                  ClusterBound<CL, OCC>::blocks)
    k_op_cluster(F f) {
  extern __shared__ u64 smem[];
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  const int b = (int)cluster.block_rank(), p = (int)(blockIdx.x >> CL);
  u64* peer[1 << CL];
#pragma unroll
  for (int k = 0; k < (1 << CL); ++k)
    peer[k] = cluster.map_shared_rank(smem, k);
  cluster.sync();  // every block of the cluster has started
  f.template phase_a<CL>(p, b, threadIdx.x, blockDim.x, peer);
  cluster.sync();  // the cross stages' remote writes are visible
  f.template phase_b<CL>(p, b, threadIdx.x, blockDim.x, smem);
  cluster.sync();  // every block's local stages are done
  f.template phase_c<CL>(p, b, threadIdx.x, blockDim.x, peer);
  cluster.sync();  // no block exits (or, K4, starts D) while another reads
                   // or writes its shared memory
  if constexpr (F::PHASES == 4)
    f.template phase_d<CL>(p, b, threadIdx.x, blockDim.x, smem);
}

template <int CL, typename F>
static int run_cluster_op(const F& f, int P, void* stream) {
  return run_cluster<CL>(k_op_cluster<CL, 1, F>,
                         k_op_cluster<CL, wide_occ(CL), F>, P, f.logn,
                         F::BUFS, stream, f);
}

template <int ROWS, int V>
static int et_run(const EncryptTail& f, int rows, void* stream) {
  const long long threads = (long long)(f.n / V) << f.lg;
  const dim3 grid((unsigned)((threads + ET_THREADS - 1) / ET_THREADS),
                  (unsigned)rows);
  k_encrypt_tail<ROWS, V><<<grid, ET_THREADS, 0, (cudaStream_t)stream>>>(f);
  return (int)cudaGetLastError();
}

#else  // host build for the CPU tests: one thread per block, blocks in order

// The clusters in turn (walk_clusters): phase A of the B blocks, then B,
// and so on.
template <int CL, typename F>
static int run_cluster_op(const F& f, int P, void*) {
  walk_clusters<CL>(P, F::PHASES, (size_t)F::BUFS << (f.logn - CL),
                    [&](int ph, int p, int b, u64* const* peer) {
                      if (ph == 0) f.template phase_a<CL>(p, b, 0, 1, peer);
                      if (ph == 1) f.template phase_b<CL>(p, b, 0, 1, peer[b]);
                      if (ph == 2) f.template phase_c<CL>(p, b, 0, 1, peer);
                      if constexpr (F::PHASES == 4)
                        if (ph == 3)
                          f.template phase_d<CL>(p, b, 0, 1, peer[b]);
                    });
  return 0;
}

template <int ROWS, int V>
static int et_run(const EncryptTail& f, int rows, void*) {
  for (int row = 0; row < rows; ++row)
    for (int k0 = 0; k0 < f.n; k0 += V)
      for (int g = 0; g < (1 << f.lg); ++g)
        encrypt_tail_coefs<ROWS, V>(f, row, k0, g);
  return 0;
}

#endif

// The encrypt tail's plan (G as log2, and V) for rk output residues of
// `rows` rows of n coefficients: the least G that leaves a thread at most
// ET_MAX_ROWS residues, and V = 2 from ET_WIDE_COEFS coefficients a launch
// where every pointer takes 16-byte accesses.  At 32k_9q (tools/tail_ab.py,
// PERF.md §6) five residues a thread beat three and eight, V = 1 won every
// J = 1 launch (twice the threads of a small grid) and V = 2 the J = 16
// one, and blocks of 128 threads beat 256 or tied.
static void et_plan(EncryptTail& f, int rows, int& V) {
  f.lg = 0;
  while (f.rk > (ET_MAX_ROWS << f.lg)) ++f.lg;
  const uintptr_t bits = (uintptr_t)f.scratch | (uintptr_t)f.e |
                         (uintptr_t)f.ra | (uintptr_t)f.m | (uintptr_t)f.ct;
  const bool wide = (long long)rows * f.n >= ET_WIDE_COEFS;
  V = wide && f.n % 2 == 0 && bits % 16 == 0 ? 2 : 1;
}

// ROWS = ceil(rk / G) (runtime) -> the instantiation, 1..ET_MAX_ROWS.
template <int V, int ROWS = 1>
static int et_dispatch(const EncryptTail& f, int rows, void* stream) {
  if ((f.rk + (1 << f.lg) - 1) >> f.lg <= ROWS)
    return et_run<ROWS, V>(f, rows, stream);
  if constexpr (ROWS < ET_MAX_ROWS)
    return et_dispatch<V, ROWS + 1>(f, rows, stream);
  return NTT_EINVAL;
}

// One launch of the encrypt tail over `rows` = 2 J rows, by the rule.
static int et_launch(EncryptTail f, int rows, void* stream) {
  if (rows < 1 || rows > 65535 || f.rk < 1 || f.n < 1 || f.r < f.rk)
    return NTT_EINVAL;
  int V;
  et_plan(f, rows, V);
  return V == 2 ? et_dispatch<2>(f, rows, stream)
                : et_dispatch<1>(f, rows, stream);
}

// The launch at B = 16 (cluster_ok: two buffers a block at 2^17), built
// only for the transforms of two buffers.
template <typename F>
static constexpr int (*op_run16())(const F&, int, void*) {
  if constexpr (F::BUFS > 1)
    return run_cluster_op<4, F>;
  else
    return nullptr;
}

// One transform over P polynomials at cluster size B (0: the rule,
// stage_cluster_log with F::BUFS buffers a block), or NTT_EINVAL where a
// block of a cluster of B cannot hold F::BUFS buffers of n/B points.
template <typename F>
static int op_launch(const F& f, int P, int B, void* stream) {
  typedef int (*Run)(const F&, int, void*);
  static const Run runs[5] = {run_cluster_op<0, F>, run_cluster_op<1, F>,
                              run_cluster_op<2, F>, run_cluster_op<3, F>,
                              op_run16<F>()};
  const int cl = cluster_log(B, f.logn, F::BUFS);
  if (P < 1 || cl < 0) return NTT_EINVAL;
  return runs[cl](f, P, stream);
}

// K3: x (P, n), y (r, n) -> out (P, n), P a multiple of r; cluster: B, or
// 0 for the rule.
extern "C" int ntt_half_polymul_cluster(const void* x, const void* y,
                                        void* out, const void* psi,
                                        const void* psi_sh, const void* ipsi,
                                        const void* ipsi_sh,
                                        const void* consts, int P, int r,
                                        int logn, int cluster, void* stream) {
  if (r < 1 || P % r) return NTT_EINVAL;
  const HalfPolymul f = {(const u64*)x, (const u64*)y, (u64*)out,
                         make_tw(psi, psi_sh, ipsi, ipsi_sh, consts), r, logn};
  return op_launch(f, P, cluster, stream);
}

// K4: s_b (n,), a (r, n), e_d (n,) -> sk, pk0 (r, n); cluster as K3's.
extern "C" int ntt_keygen_fused_cluster(const void* sb, const void* a,
                                        const void* ed, void* sk, void* pk0,
                                        const void* psi, const void* psi_sh,
                                        const void* ipsi, const void* ipsi_sh,
                                        const void* consts, int r, int logn,
                                        int cluster, void* stream) {
  const Keygen f = {(const int*)sb, (const u64*)a, (const int*)ed, (u64*)sk,
                    (u64*)pk0, make_tw(psi, psi_sh, ipsi, ipsi_sh, consts),
                    logn};
  return op_launch(f, r, cluster, stream);
}

// K5's transform: u_b (J, n), pk (2, r, n), ed (J, 2, n) -> scratch
// (J, 2, r, n); cluster as K3's.
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
  return op_launch(f, J * r, cluster, stream);
}

// K5's and 13's tail, and 19's drop with m null: scratch (J, 2, r, n),
// m (J, n) -> ct (J, 2, r-1, n).
extern "C" int ntt_encrypt_tail(const void* scratch, const void* m, void* ct,
                                const void* tc, u64 q_last, u64 half,
                                u64 fix_th, int J, int r, int n, void* stream) {
  if (r < 2 || J < 1) return NTT_EINVAL;
  const EncryptTail f = {(const u64*)scratch, nullptr, nullptr,
                         (const long long*)m, (u64*)ct, (const u64*)tc,
                         q_last, half, fix_th, r, 0, r - 1, n, 0};
  return et_launch(f, 2 * J, stream);
}

// Kernel 14: c and e (2, r, n), m (n,) -> ct (2, r-1, n).
extern "C" int ntt_encrypt_tail_e(const void* c, const void* e, const void* m,
                                  void* ct, const void* tc, u64 q_last,
                                  u64 half, u64 fix_th, int r, int n,
                                  void* stream) {
  if (r < 2 || !e) return NTT_EINVAL;
  const EncryptTail f = {(const u64*)c, (const u64*)e, nullptr,
                         (const long long*)m, (u64*)ct, (const u64*)tc,
                         q_last, half, fix_th, r, r, r - 1, n, 0};
  return et_launch(f, 2, stream);
}

// Kernel 18: c (2, r, n) = INTT(NTT(u) . pk_h) for one message, NTT(u)
// computed once per modulus (the transform above with no e); cluster as
// K3's.
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
  return op_launch(f, r, cluster, stream);
}

// Kernel 16: one rank's padded tail, c and e (2, rl, n), ra (2, n) ready,
// m (n,) -> ct (2, rl, n).
extern "C" int ntt_encrypt_tail_padded(const void* c, const void* e,
                                       const void* ra, const void* m, void* ct,
                                       const void* tc, u64 q_last, u64 fix_th,
                                       int rl, int n, void* stream) {
  if (!e || !ra) return NTT_EINVAL;
  const EncryptTail f = {(const u64*)c, (const u64*)e, (const u64*)ra,
                         (const long long*)m, (u64*)ct, (const u64*)tc,
                         q_last, 0, fix_th, rl, rl, rl, n, 0};
  return et_launch(f, 2, stream);
}

// Kernel 16's tail with no e and no message: the sharded key switch's
// modulus drop (parallel/spmd_mult.py) of one rank's accumulators c
// (2, rl, n) from the all-reduced ra (2, n) -> ct (2, rl, n).
extern "C" int ntt_drop_last_padded(const void* c, const void* ra, void* ct,
                                    const void* tc, u64 q_last, int rl, int n,
                                    void* stream) {
  if (!ra) return NTT_EINVAL;
  const EncryptTail f = {(const u64*)c, nullptr, (const u64*)ra, nullptr,
                         (u64*)ct, (const u64*)tc, q_last, 0, 0, rl, 0, rl,
                         n, 0};
  return et_launch(f, 2, stream);
}
