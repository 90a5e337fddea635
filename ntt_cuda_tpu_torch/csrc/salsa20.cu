// Salsa20/20 keystream, written in its byte order.
//
// K1, ntt_salsa20, replaces the TPU kernel ntt_cuda_tpu/ops/salsa20.py
// _keystream_pallas (salsa20.py:174, pallas_call :200); kernel 6,
// ntt_salsa20_batch, replaces _keystream_pallas_batch (:249, pallas_call
// :283), the J streams of a batched encryption in one launch.  Fixed key
// byte, nonce in state words 6/7, 64-bit block counter counter0 + b in
// words 8/9, carried into word 9 as _salsa_chunk's is (salsa20.py:130-132;
// the reference's VecCrypt, distributions.cuh:48-155).
//
// Output: the stream itself, as the reference's byte buffer holds it
// (generate_random_default): u32 word w = stream bytes 4w..4w+3,
// little-endian, so block b is words 16b..16b+15.  Kernel 6 writes J such
// streams one after the other, row j the stream of nonces[j] (a (J,) array
// of u64 bit patterns on the device).  The TPU kernel wrote one plane a
// word position for its (8, 128) vregs, and its callers transposed them
// back; here the stream is written once, in order, and every draw is a
// view of it.
//
// Bound on the card: the rounds' integer instructions.  A block is 64
// bytes out and 10 double rounds of 8 quarter-rounds of 4 (add, rotate,
// xor) steps: about 960 32-bit instructions (nvcc puts a third of them,
// the adds, on the FMA pipe), 10 clocks of an SM's 64 integer ALU lanes,
// against 5 clocks for its 64 bytes at the SM's share of 3.35 TB/s.  Two
// forms, by the launch's size (tools/salsa_ab.py, run on the card):
//   * k_salsa20, from SALSA_LANES_BELOW blocks a launch: one thread a
//     block, the state in 16 registers, the rounds fully unrolled (four
//     independent quarter-rounds for the scheduler).  The CTA's 64 blocks
//     go through a swizzled shared-memory tile and out as whole lines:
//     four 16-byte stores a thread, 64 bytes apart, cost 15-20% at
//     keygen's and a batch's grids, where every warp stores at once at
//     the end;
//   * k_salsa20_lanes, below it: four lanes a block, one quarter-round a
//     lane, the row round's words exchanged with __shfl_sync.  A small
//     grid is one warp a scheduler or less, latency-bound, and four times
//     the threads take 10-20% off (encrypt's 4608 blocks).
//
// k_salsa20_draws (ntt_salsa20_draws) is kernel 6 fused with its
// converters: the compact draws of a batched encryption, u_b (J, n) and
// e_d (J, 2, n) int32, straight from the J streams, with no stream
// written.  Each CTA makes k_salsa20's staged tile of 64 blocks, then
// reads it back in output order and converts in registers: stream words
// [0, n/4) are the ternary bytes (bfv_encryption.cuh:247), a word read
// gives four byte / 85 - 1 values and one 16-byte store; words [n/4,
// 9n/4) are e0 then e1, a 16-byte chunk read gives four Gaussian values
// and one 16-byte store.  A warp's stores cover 512 bytes in a row.  The
// Gaussian value is the pinned spec of ops/sampling.py gaussian_int:
// -19 + #{bound <= u} over GAUSS_ICDF_BOUNDS, by a six-step search over
// the bounds padded to 64 in shared memory (38 compares a word would cost
// more than the rounds do), u == 0 -> -16, u >= 2^32 - 128 -> +16.  The
// nonces are the user's, (J,) int64 on the device: encryption's map (bit
// 63 set on a nonzero nonce) is applied here, so the launch reads nothing
// from the host and a CUDA graph replays it at whatever they then hold.
// Bound: the rounds' instructions and the search's, against 12 bytes out
// a coefficient (4 of u_b, 8 of e_d) at 3.35 TB/s.

#include "modarith.cuh"

#define SALSA_TILE 64            // k_salsa20: blocks (threads) a CTA
#define SALSA_LANES_CTA 128      // k_salsa20_lanes: threads a CTA
#define SALSA_LANES_BELOW 8192   // blocks a launch below which it runs

NTT_HD u32 rotl32(u32 x, int c) { return (x << c) | (x >> (32 - c)); }

// One quarter-round on the words (a, b, c, d).
#define SALSA_QR(a, b, c, d)  \
  b ^= rotl32(a + d, 7);      \
  c ^= rotl32(b + a, 9);      \
  d ^= rotl32(c + b, 13);     \
  a ^= rotl32(d + c, 18);

// The 16 output words of block counter `ctr` of the (kw, nonce) stream.
NTT_HD void salsa20_block(u32 x[16], u32 kw, u64 nonce, u64 ctr) {
  const u32 j[16] = {0x61707865u, kw, kw, kw, kw, 0x3320646Eu,
                     (u32)nonce, (u32)(nonce >> 32), (u32)ctr,
                     (u32)(ctr >> 32), 0x79622D32u, kw, kw, kw, kw,
                     0x6B206574u};
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
  for (int p = 0; p < 16; ++p) x[p] = j[p];
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
  for (int i = 0; i < 10; ++i) {  // 20 rounds: 10 double rounds
    SALSA_QR(x[0], x[4], x[8], x[12])
    SALSA_QR(x[5], x[9], x[13], x[1])
    SALSA_QR(x[10], x[14], x[2], x[6])
    SALSA_QR(x[15], x[3], x[7], x[11])
    SALSA_QR(x[0], x[1], x[2], x[3])
    SALSA_QR(x[5], x[6], x[7], x[4])
    SALSA_QR(x[10], x[11], x[8], x[9])
    SALSA_QR(x[15], x[12], x[13], x[14])
  }
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
  for (int p = 0; p < 16; ++p) x[p] += j[p];
}

// The four-lane form: lane l holds column l turned to its diagonal, (a, b,
// c, d) = words 5l, 5l + 4, 5l + 8, 5l + 12 (mod 16), so the column round
// is one quarter-round a lane, and the row round's (b, c, d) of lane l are
// lane l + 1's d, lane l + 2's c and lane l + 3's b (mod 4).  Lane l's
// input words:
NTT_HD void salsa20_lane_input(int l, u32 kw, u64 nonce, u64 ctr, u32 w[4]) {
  w[0] = l == 0 ? 0x61707865u : l == 1 ? 0x3320646Eu
       : l == 2 ? 0x79622D32u : 0x6B206574u;
  w[1] = l == 1 ? (u32)(ctr >> 32) : kw;
  w[2] = l == 0 ? (u32)ctr : l == 3 ? (u32)(nonce >> 32) : kw;
  w[3] = l == 2 ? (u32)nonce : kw;
}

// The staged tile of k_salsa20: 16-byte chunk k of the tile's block t sits
// at slot salsa20_tile_slot(t, k) (no bank conflict among the 8 threads of
// a 16-byte store's phase), and the tile's chunk t + k SALSA_TILE, which
// thread t stores, at salsa20_tile_read(t) + k SALSA_TILE.
NTT_HD int salsa20_tile_slot(int t, int k) {
  return 4 * t + (k ^ ((t >> 1) & 3));
}

NTT_HD int salsa20_tile_read(int t) {
  return 4 * (t >> 2) + ((t & 3) ^ ((t >> 3) & 3));
}

// The pinned Gaussian thresholds (ops/sampling.py GAUSS_ICDF_BOUNDS,
// which a test holds this table to), padded to a power of two with a
// bound no word below 2^32 - 1 reaches (that word reads +16 anyway).
#define GAUSS_BOUNDS 38
#define GAUSS_SEARCH 64
#define GAUSS_PAD 0xFFFFFFFFu
#define GAUSS_TABLE                                                       \
  {7u, 40u, 233u, 1232u, 5940u, 26078u, 104261u, 379750u, 1260811u,       \
   3818335u, 10556606u, 26670310u, 61645758u, 130551381u, 253768664u,     \
   453762321u, 748401120u, 1142399168u, 1620621248u, 2674346113u,         \
   3152568192u, 3546566273u, 3841204865u, 4041198721u, 4164415872u,       \
   4233321601u, 4268297088u, 4284410752u, 4291148929u, 4293706369u,       \
   4294587521u, 4294862977u, 4294941313u, 4294961281u, 4294966144u,       \
   4294967168u, 4294967168u, 4294967168u}

// Entry i (< GAUSS_SEARCH) of the padded search table.
NTT_HD u32 gauss_table_entry(int i) {
  const u32 b[GAUSS_BOUNDS] = GAUSS_TABLE;
  return i < GAUSS_BOUNDS ? b[i] : GAUSS_PAD;
}

// The Gaussian value of word u: #{bound <= u} by a branchless search of
// the sorted padded table `tab`, then the spec's two ends.
NTT_HD int gauss_draw(u32 u, const u32* tab) {
  int pos = 0;
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
  for (int s = GAUSS_SEARCH / 2; s >= 1; s >>= 1)
    pos += tab[pos + s - 1] <= u ? s : 0;
  return u == 0u ? -16 : u >= 0xFFFFFF80u ? 16 : pos - 19;
}

// The ternary value of stream byte k of word w: byte / 85 - 1 (byte 255
// -> 2).
NTT_HD int ternary_draw(u32 w, int k) {
  return (int)(((w >> (8 * k)) & 0xFFu) / 85u) - 1;
}

// Encryption's effective nonce: bit 63 set on every nonzero nonce.
NTT_HD u64 encrypt_nonce(u64 nonce) {
  return nonce ? nonce | (1ull << 63) : 0ull;
}

// Four int32 draws to p, 16-byte aligned: one vector store on the card.
NTT_HD void store_draws4(int* p, int a, int b, int c, int d) {
#ifdef __CUDA_ARCH__
  *(int4*)p = make_int4(a, b, c, d);
#else
  p[0] = a;
  p[1] = b;
  p[2] = c;
  p[3] = d;
#endif
}

// Thread t's part of a draws CTA's read-back: `tile` holds blocks [b0, b0
// + cnt) of stream j as k_salsa20 stages them (chunk k of block i at slot
// salsa20_tile_slot(i, k)), `tab` the search table; u_b and e_d are row
// j's (n and 2n int32).  Tile word w is stream word 16 b0 + w: below n/4
// a word of four ternary bytes, from there a Gaussian word of e_d's flat
// (2, n), read four at a time.  n % 64 == 0: the stream is 9n/64 whole
// blocks, and n/4 a block's first word.
NTT_HD void salsa20_draws_out(const u32* tile, const u32* tab, int t,
                              long long b0, int cnt, int n, int* u_b,
                              int* e_d) {
  const long long w0 = 16 * b0, nt = n / 4;
  const int tw = nt - w0 < 16 * cnt ? (int)(nt - w0) : 16 * cnt;
  for (int w = t; w < tw; w += SALSA_TILE) {
    const u32 x = tile[4 * salsa20_tile_slot(w >> 4, (w >> 2) & 3) + (w & 3)];
    store_draws4(u_b + 4 * (w0 + w), ternary_draw(x, 0), ternary_draw(x, 1),
                 ternary_draw(x, 2), ternary_draw(x, 3));
  }
  for (int c = (tw > 0 ? tw / 4 : 0) + t; c < 4 * cnt; c += SALSA_TILE) {
    const int slot = salsa20_tile_slot(c >> 2, c & 3);
#ifdef __CUDA_ARCH__
    const uint4 x4 = ((const uint4*)tile)[slot];
    const u32 x[4] = {x4.x, x4.y, x4.z, x4.w};
#else
    const u32* x = tile + 4 * slot;
#endif
    store_draws4(e_d + (w0 - nt + 4 * c), gauss_draw(x[0], tab),
                 gauss_draw(x[1], tab), gauss_draw(x[2], tab),
                 gauss_draw(x[3], tab));
  }
}

#ifdef __CUDACC__

// Grid: blocks of the stream in x, streams in y.  nonces null: one stream
// of `nonce` (K1); else stream j is nonces[j]'s (kernel 6).
__global__ void __launch_bounds__(SALSA_TILE)
    k_salsa20(uint4* __restrict__ ks, long long nb, u32 kw,
              const u64* __restrict__ nonces, u64 nonce, u64 ctr0) {
  __shared__ uint4 tile[4 * SALSA_TILE];
  const int t = threadIdx.x;
  const long long b0 = (long long)blockIdx.x * SALSA_TILE, j = blockIdx.y;
  u32 x[16];
  // past nb (the last CTA only): computed, not stored
  salsa20_block(x, kw, nonces ? nonces[j] : nonce, ctr0 + (u64)(b0 + t));
#pragma unroll
  for (int k = 0; k < 4; ++k)
    tile[salsa20_tile_slot(t, k)] =
        make_uint4(x[4 * k], x[4 * k + 1], x[4 * k + 2], x[4 * k + 3]);
  __syncthreads();
  const int r = salsa20_tile_read(t);
  uint4* o = ks + (j * nb + b0) * 4 + t;
  if (nb - b0 >= SALSA_TILE) {
#pragma unroll
    for (int k = 0; k < 4; ++k) o[k * SALSA_TILE] = tile[r + k * SALSA_TILE];
  } else {
    for (int k = 0; k < 4; ++k)
      if (t + k * SALSA_TILE < 4 * (nb - b0))
        o[k * SALSA_TILE] = tile[r + k * SALSA_TILE];
  }
}

__global__ void __launch_bounds__(SALSA_LANES_CTA)
    k_salsa20_lanes(u32* __restrict__ ks, long long nb, u32 kw,
                    const u64* __restrict__ nonces, u64 nonce, u64 ctr0) {
  const long long b =
      ((long long)blockIdx.x * SALSA_LANES_CTA + threadIdx.x) >> 2;
  const long long j = blockIdx.y;
  const int l = threadIdx.x & 3;
  u32 w0[4];
  salsa20_lane_input(l, kw, nonces ? nonces[j] : nonce, ctr0 + (u64)b, w0);
  u32 a = w0[0], bb = w0[1], c = w0[2], d = w0[3];
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    SALSA_QR(a, bb, c, d)
    u32 rb = __shfl_sync(0xffffffffu, d, (l + 1) & 3, 4);
    u32 rc = __shfl_sync(0xffffffffu, c, (l + 2) & 3, 4);
    u32 rd = __shfl_sync(0xffffffffu, bb, (l + 3) & 3, 4);
    SALSA_QR(a, rb, rc, rd)
    d = __shfl_sync(0xffffffffu, rb, (l + 3) & 3, 4);
    c = __shfl_sync(0xffffffffu, rc, (l + 2) & 3, 4);
    bb = __shfl_sync(0xffffffffu, rd, (l + 1) & 3, 4);
  }
  if (b >= nb) return;
  u32* o = ks + (j * nb + b) * 16;
  o[(5 * l) & 15] = a + w0[0];
  o[(5 * l + 4) & 15] = bb + w0[1];
  o[(5 * l + 8) & 15] = c + w0[2];
  o[(5 * l + 12) & 15] = d + w0[3];
}

// Grid: the 9n/64 blocks of stream j in x (SALSA_TILE a CTA), j in y;
// block counters from 0.  u_b: (J, n), e_d: (J, 2, n) int32.
__global__ void __launch_bounds__(SALSA_TILE)
    k_salsa20_draws(int* __restrict__ u_b, int* __restrict__ e_d, int n,
                    u32 kw, const u64* __restrict__ nonces) {
  __shared__ uint4 tile[4 * SALSA_TILE];
  __shared__ u32 tab[GAUSS_SEARCH];
  const int t = threadIdx.x;
  const long long nb = 9ll * n / 64, b0 = (long long)blockIdx.x * SALSA_TILE;
  const long long j = blockIdx.y;
  static_assert(SALSA_TILE == GAUSS_SEARCH, "a thread an entry of tab");
  tab[t] = gauss_table_entry(t);
  u32 x[16];
  salsa20_block(x, kw, encrypt_nonce(nonces[j]), (u64)(b0 + t));
#pragma unroll
  for (int k = 0; k < 4; ++k)
    tile[salsa20_tile_slot(t, k)] =
        make_uint4(x[4 * k], x[4 * k + 1], x[4 * k + 2], x[4 * k + 3]);
  __syncthreads();
  salsa20_draws_out((const u32*)tile, tab, t, b0,
                    (int)(nb - b0 < SALSA_TILE ? nb - b0 : SALSA_TILE), n,
                    u_b + j * n, e_d + 2 * j * n);
}

static int salsa20_draws_launch(void* u_b, void* e_d, int n, u32 kw,
                                const void* nonces, int J, void* stream) {
  if (n < 64 || n % 64 || J < 1 || J > 65535)
    return (int)cudaErrorInvalidValue;
  const long long nb = 9ll * n / 64;
  const dim3 grid((unsigned)((nb + SALSA_TILE - 1) / SALSA_TILE),
                  (unsigned)J);
  k_salsa20_draws<<<grid, SALSA_TILE, 0, (cudaStream_t)stream>>>(
      (int*)u_b, (int*)e_d, n, kw, (const u64*)nonces);
  return (int)cudaGetLastError();
}

static int salsa20_launch(void* ks, long long nb, u32 kw, const void* nonces,
                          int J, u64 nonce, u64 ctr0, void* stream) {
  if (nb < 1 || J < 1 || J > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const u64* ns = (const u64*)nonces;
  if (nb * J < SALSA_LANES_BELOW) {
    const dim3 grid((unsigned)((4 * nb + SALSA_LANES_CTA - 1) /
                               SALSA_LANES_CTA), (unsigned)J);
    k_salsa20_lanes<<<grid, SALSA_LANES_CTA, 0, st>>>((u32*)ks, nb, kw, ns,
                                                      nonce, ctr0);
  } else {
    const dim3 grid((unsigned)((nb + SALSA_TILE - 1) / SALSA_TILE),
                    (unsigned)J);
    k_salsa20<<<grid, SALSA_TILE, 0, st>>>((uint4*)ks, nb, kw, ns, nonce,
                                           ctr0);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* ntt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

#else  // host build for the CPU tests: each form's index algebra in turn

// k_salsa20_lanes' block: its four lanes in step, the shuffles as reads of
// the other lanes' words.
static void salsa20_lanes_block(u32* o, u32 kw, u64 nonce, u64 ctr) {
  u32 w0[4][4], s[4][4], r[4][3];
  for (int l = 0; l < 4; ++l) {
    salsa20_lane_input(l, kw, nonce, ctr, w0[l]);
    for (int k = 0; k < 4; ++k) s[l][k] = w0[l][k];
  }
  for (int i = 0; i < 10; ++i) {
    for (int l = 0; l < 4; ++l) { SALSA_QR(s[l][0], s[l][1], s[l][2], s[l][3]) }
    for (int l = 0; l < 4; ++l) {
      r[l][0] = s[(l + 1) & 3][3];
      r[l][1] = s[(l + 2) & 3][2];
      r[l][2] = s[(l + 3) & 3][1];
    }
    for (int l = 0; l < 4; ++l) { SALSA_QR(s[l][0], r[l][0], r[l][1], r[l][2]) }
    for (int l = 0; l < 4; ++l) {
      s[l][3] = r[(l + 3) & 3][0];
      s[l][2] = r[(l + 2) & 3][1];
      s[l][1] = r[(l + 1) & 3][2];
    }
  }
  for (int l = 0; l < 4; ++l)
    for (int k = 0; k < 4; ++k) o[(5 * l + 4 * k) & 15] = s[l][k] + w0[l][k];
}

static int salsa20_launch(void* ks, long long nb, u32 kw, const void* nonces,
                          int J, u64 nonce, u64 ctr0, void*) {
  if (nb < 1 || J < 1 || J > 65535) return 1;
  for (long long j = 0; j < J; ++j) {
    const u64 nn = nonces ? ((const u64*)nonces)[j] : nonce;
    u32* row = (u32*)ks + j * nb * 16;
    if (nb * J < SALSA_LANES_BELOW) {
      for (long long b = 0; b < nb; ++b)
        salsa20_lanes_block(row + b * 16, kw, nn, ctr0 + (u64)b);
      continue;
    }
    u32 tile[4 * SALSA_TILE][4];   // k_salsa20's tile, CTA by CTA
    for (long long b0 = 0; b0 < nb; b0 += SALSA_TILE) {
      for (int t = 0; t < SALSA_TILE; ++t) {
        u32 x[16];
        salsa20_block(x, kw, nn, ctr0 + (u64)(b0 + t));
        for (int k = 0; k < 4; ++k)
          for (int w = 0; w < 4; ++w)
            tile[salsa20_tile_slot(t, k)][w] = x[4 * k + w];
      }
      for (int t = 0; t < SALSA_TILE; ++t)
        for (int k = 0; k < 4; ++k) {
          const long long s = t + k * SALSA_TILE;
          if (s < 4 * (nb - b0))
            for (int w = 0; w < 4; ++w)
              row[(b0 * 4 + s) * 4 + w] =
                  tile[salsa20_tile_read(t) + k * SALSA_TILE][w];
        }
    }
  }
  return 0;
}

// k_salsa20_draws CTA by CTA: each thread's block staged into the tile,
// then each thread's read-back.
static int salsa20_draws_launch(void* u_b, void* e_d, int n, u32 kw,
                                const void* nonces, int J, void*) {
  if (n < 64 || n % 64 || J < 1 || J > 65535) return 1;
  const long long nb = 9ll * n / 64;
  u32 tab[GAUSS_SEARCH];
  for (int i = 0; i < GAUSS_SEARCH; ++i) tab[i] = gauss_table_entry(i);
  for (long long j = 0; j < J; ++j) {
    const u64 nn = encrypt_nonce(((const u64*)nonces)[j]);
    for (long long b0 = 0; b0 < nb; b0 += SALSA_TILE) {
      u32 tile[4 * SALSA_TILE][4];
      for (int t = 0; t < SALSA_TILE; ++t) {
        u32 x[16];
        salsa20_block(x, kw, nn, (u64)(b0 + t));
        for (int k = 0; k < 4; ++k)
          for (int w = 0; w < 4; ++w)
            tile[salsa20_tile_slot(t, k)][w] = x[4 * k + w];
      }
      const int cnt = (int)(nb - b0 < SALSA_TILE ? nb - b0 : SALSA_TILE);
      for (int t = 0; t < SALSA_TILE; ++t)
        salsa20_draws_out(&tile[0][0], tab, t, b0, cnt, n,
                          (int*)u_b + j * n, (int*)e_d + 2 * j * n);
    }
  }
  return 0;
}

// The host build's seam for the tests (the card's library has none): the
// converters of k_salsa20_draws on given words, count of them: word i's
// four ternary values to tern[4i..4i+3], its Gaussian value to gauss[i].
extern "C" int ntt_draws_convert(const void* words, long long count,
                                 void* tern, void* gauss) {
  u32 tab[GAUSS_SEARCH];
  for (int i = 0; i < GAUSS_SEARCH; ++i) tab[i] = gauss_table_entry(i);
  for (long long i = 0; i < count; ++i) {
    const u32 w = ((const u32*)words)[i];
    for (int k = 0; k < 4; ++k) ((int*)tern)[4 * i + k] = ternary_draw(w, k);
    ((int*)gauss)[i] = gauss_draw(w, tab);
  }
  return 0;
}

extern "C" const char* ntt_error_string(int) { return "host build"; }

#endif

// ks: nb * 16 u32 words.
extern "C" int ntt_salsa20(void* ks, long long nb, u32 kw, u64 nonce,
                           u64 ctr0, void* stream) {
  return salsa20_launch(ks, nb, kw, nullptr, 1, nonce, ctr0, stream);
}

// ks: J * nb * 16 u32 words; nonces: (J,) u64.
extern "C" int ntt_salsa20_batch(void* ks, long long nb, u32 kw,
                                 const void* nonces, int J, u64 ctr0,
                                 void* stream) {
  return salsa20_launch(ks, nb, kw, nonces, J, 0, ctr0, stream);
}

// The compact draws of a batched encryption: u_b (J, n) and e_d (J, 2, n)
// int32 from the streams of the (J,) user nonces (u64; encryption's map
// applied here), the key word kw; n % 64 == 0.
extern "C" int ntt_salsa20_draws(void* u_b, void* e_d, int n, u32 kw,
                                 const void* nonces, int J, void* stream) {
  return salsa20_draws_launch(u_b, e_d, n, kw, nonces, J, stream);
}
