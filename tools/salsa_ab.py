"""K1's and kernel 6's design A/B (the Salsa20 keystream), on one card.

    python3 tools/salsa_ab.py

Builds, under build/salsa_ab, a library from a copy of csrc/salsa20.cu and
variant kernels beside it (AB_SRC), each writing the same stream in byte
order:

* the rotate: `ROT` 0 the library's rotl32 (`SHF.L.W`); 1 a 32 x 32 ->
  64-bit product by 2^c (`IMAD.WIDE.U32`, on the FMA pipe) whose two
  halves feed the xor's three-way `LOP3`; 2 that, and on every other step
  the add as a multiply-add by 1 (`IMAD`).  The multipliers are kernel
  arguments, so ptxas cannot turn them back into shifts and adds;
* the 10 double rounds unrolled 1, 2 or 10 times (code size against loop
  overhead);
* `direct`: one thread a 64-byte block and four 16-byte stores;
  `staged`: the CTA's blocks staged through shared memory (swizzled, no
  bank conflict), a barrier, whole lines out; `wstaged`: the same a warp
  at a time, no CTA barrier; `lean`: the CTA-staged store with fewer
  instructions (a static tile, one read slot, full tiles unpredicated),
  also with the shared-memory carveout at its maximum; `lanes4`: four
  lanes a block, one quarter-round a lane, `__shfl_sync` for the row
  round;
* 64, 128 or 256 threads a CTA.

Prints the card's name and power limit, each variant's registers and
spills (`ptxas -v`) and SASS by pipe.  Then at the main paths' shapes
(chip_smoke.keystream_shapes: keygen and encrypt at 16k_5q and 32k_9q,
relin_keygen at 32k_9q, kernel 6 at J = 16) every variant's output is
held against the plain version (exact), and device us per call
(torch.profiler, 10 calls a window) is taken in turns library, variants,
variants reversed, library, where the library is the package's own
launch.  Prints one JSON line.

Needs a CUDA card and raises without one.  Imports no jax.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from chip_smoke import device_us  # noqa: E402
from ntt_cuda_tpu_torch import cuda  # noqa: E402
from ntt_cuda_tpu_torch.ops import salsa20  # noqa: E402

SHAPES = ("encrypt 16k_5q", "keygen 16k_5q", "encrypt 32k_9q",
          "keygen 32k_9q", "relin_keygen 32k_9q", "J=16 32k_9q")
FORMS = {"direct": 0, "staged": 1, "wstaged": 2, "lanes4": 3, "lean": 4,
         "lean+carveout": 5}
# (form, rotate, double rounds unrolled, threads a CTA) of each variant:
# every rotate fully unrolled at 64-256 threads, then the unroll factors
# and the staged forms with the library's rotate
VARIANTS = ([("direct", rot, 10, t) for rot in (0, 1, 2)
             for t in (64, 128, 256)]
            + [(form, rot, 10, t) for form in ("staged", "lanes4")
               for rot in (0, 1) for t in (128, 256)]
            + [("direct", 0, u, t) for u in (1, 2) for t in (64, 128)]
            + [("staged", 0, 2, t) for t in (64, 128)]
            + [("staged", 0, 10, 64)]
            + [("wstaged", 0, u, t) for u in (1, 2, 10) for t in (64, 128)]
            + [("lanes4", 0, 1, t) for t in (64, 128, 256)]
            + [("lanes4", 0, 10, 64)]
            + [("lean", 0, 10, t) for t in (64, 128)]
            + [("lean+carveout", 0, 10, 128)])

AB_SRC = r"""
#include "salsa20.cu"

// 1, 2^7, 2^9, 2^13, 2^18 as kernel arguments (unknown to ptxas)
struct AbMul { u32 m[5]; };

// x ^ rotl(a + d, c), the add on the FMA pipe where `alt` and ROT == 2
template <int ROT>
__device__ __forceinline__ u32 ab_step(u32 x, u32 a, u32 d, u32 mul, int c,
                                       bool alt, u32 one) {
  if (ROT == 0) return x ^ rotl32(a + d, c);
  const u32 t = (ROT == 2 && alt) ? a * one + d : a + d;
  const u64 p = (u64)t * mul;
  return x ^ (u32)p ^ (u32)(p >> 32);
}

#define AB_QR(a, b, c, d)                                             \
  b = ab_step<ROT>(b, a, d, m.m[1], 7, false, m.m[0]);                \
  c = ab_step<ROT>(c, b, a, m.m[2], 9, true, m.m[0]);                 \
  d = ab_step<ROT>(d, c, b, m.m[3], 13, false, m.m[0]);               \
  a = ab_step<ROT>(a, d, c, m.m[4], 18, true, m.m[0]);

// the 10 double rounds unrolled UNROLL times
template <int ROT, int UNROLL>
__device__ __forceinline__ void ab_block(u32 x[16], u32 kw, u64 nonce,
                                         u64 ctr, const AbMul& m) {
  const u32 j[16] = {0x61707865u, kw, kw, kw, kw, 0x3320646Eu,
                     (u32)nonce, (u32)(nonce >> 32), (u32)ctr,
                     (u32)(ctr >> 32), 0x79622D32u, kw, kw, kw, kw,
                     0x6B206574u};
#pragma unroll
  for (int p = 0; p < 16; ++p) x[p] = j[p];
#pragma unroll UNROLL
  for (int i = 0; i < 10; ++i) {
    AB_QR(x[0], x[4], x[8], x[12])
    AB_QR(x[5], x[9], x[13], x[1])
    AB_QR(x[10], x[14], x[2], x[6])
    AB_QR(x[15], x[3], x[7], x[11])
    AB_QR(x[0], x[1], x[2], x[3])
    AB_QR(x[5], x[6], x[7], x[4])
    AB_QR(x[10], x[11], x[8], x[9])
    AB_QR(x[15], x[12], x[13], x[14])
  }
#pragma unroll
  for (int p = 0; p < 16; ++p) x[p] += j[p];
}

// chunk k of block t of a staged tile, swizzled: no bank conflict on the
// 16-byte stores (8 threads a phase) or on the whole-line reads
__device__ __forceinline__ int ab_slot(int t, int k) {
  return 4 * t + (k ^ ((t >> 1) & 3));
}

// one thread a block.  FORM 0: four 16-byte stores a thread; 1: the CTA's
// blocks staged through shared memory, a barrier, whole lines out; 2: each
// warp's 32 blocks through its own 2 KB, __syncwarp, whole lines out
template <int ROT, int FORM, int UNROLL>
__global__ void __launch_bounds__(256)
    k_ab_salsa(uint4* ks, long long nb, u32 kw, const u64* nonces,
               u64 nonce, u64 ctr0, AbMul m) {
  extern __shared__ uint4 st[];
  const int t = threadIdx.x;
  const long long b = (long long)blockIdx.x * blockDim.x + t;
  const long long j = blockIdx.y;
  u32 x[16];
  if (FORM == 0) {
    if (b >= nb) return;
    ab_block<ROT, UNROLL>(x, kw, nonces ? nonces[j] : nonce, ctr0 + (u64)b,
                          m);
    uint4* o = ks + (j * nb + b) * 4;
    o[0] = make_uint4(x[0], x[1], x[2], x[3]);
    o[1] = make_uint4(x[4], x[5], x[6], x[7]);
    o[2] = make_uint4(x[8], x[9], x[10], x[11]);
    o[3] = make_uint4(x[12], x[13], x[14], x[15]);
    return;
  }
  const int lt = FORM == 1 ? t : (t & 31);          // block in the tile
  uint4* tile = FORM == 1 ? st : st + (t >> 5) * 128;
  if (b < nb) {
    ab_block<ROT, UNROLL>(x, kw, nonces ? nonces[j] : nonce, ctr0 + (u64)b,
                          m);
    tile[ab_slot(lt, 0)] = make_uint4(x[0], x[1], x[2], x[3]);
    tile[ab_slot(lt, 1)] = make_uint4(x[4], x[5], x[6], x[7]);
    tile[ab_slot(lt, 2)] = make_uint4(x[8], x[9], x[10], x[11]);
    tile[ab_slot(lt, 3)] = make_uint4(x[12], x[13], x[14], x[15]);
  }
  if (FORM == 1) __syncthreads(); else __syncwarp();
  const int width = FORM == 1 ? blockDim.x : 32;
  const long long b0 = b - lt;                      // the tile's first block
  uint4* o = ks + (j * nb + b0) * 4;
  for (int k = 0; k < 4; ++k) {
    const int s = lt + k * width, tb = s >> 2;
    if (b0 + tb < nb) o[s] = tile[ab_slot(tb, s & 3)];
  }
}

// the CTA-staged store made lean: a static tile of T blocks, every thread
// computes (past nb only in the last CTA, not stored), chunk t + k T of
// the tile sits at one slot r + k T, and a full tile stores unpredicated
template <int ROT, int T>
__global__ void __launch_bounds__(T)
    k_ab_salsa_lean(uint4* ks, long long nb, u32 kw, const u64* nonces,
                    u64 nonce, u64 ctr0, AbMul m) {
  __shared__ uint4 tile[4 * T];
  const int t = threadIdx.x;
  const long long b0 = (long long)blockIdx.x * T, j = blockIdx.y;
  u32 x[16];
  ab_block<ROT, 10>(x, kw, nonces ? nonces[j] : nonce, ctr0 + (u64)(b0 + t),
                    m);
  tile[ab_slot(t, 0)] = make_uint4(x[0], x[1], x[2], x[3]);
  tile[ab_slot(t, 1)] = make_uint4(x[4], x[5], x[6], x[7]);
  tile[ab_slot(t, 2)] = make_uint4(x[8], x[9], x[10], x[11]);
  tile[ab_slot(t, 3)] = make_uint4(x[12], x[13], x[14], x[15]);
  __syncthreads();
  const int r = 4 * (t >> 2) + ((t & 3) ^ ((t >> 3) & 3));
  uint4* o = ks + (j * nb + b0) * 4 + t;
  if (nb - b0 >= T) {
#pragma unroll
    for (int k = 0; k < 4; ++k) o[k * T] = tile[r + k * T];
  } else {
    for (int k = 0; k < 4; ++k)
      if (t + k * T < 4 * (nb - b0)) o[k * T] = tile[r + k * T];
  }
}

// four lanes a block: lane l holds column l rotated to its diagonal, a =
// word 5l, b = 5l + 4, c = 5l + 8, d = 5l + 12 (mod 16), so the column
// round is one quarter-round a lane; the row round's b, c, d of lane l
// are lane l + 1's d, l + 2's c and l + 3's b.
template <int ROT, int UNROLL>
__global__ void __launch_bounds__(256)
    k_ab_salsa_lanes4(u32* ks, long long nb, u32 kw, const u64* nonces,
                      u64 nonce, u64 ctr0, AbMul m) {
  const long long b = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 2;
  const int l = threadIdx.x & 3;
  const long long j = blockIdx.y;
  const u64 nn = nonces ? nonces[j] : nonce, ctr = ctr0 + (u64)b;
  const u32 a0 = l == 0 ? 0x61707865u : l == 1 ? 0x3320646Eu
               : l == 2 ? 0x79622D32u : 0x6B206574u;
  const u32 b0 = l == 1 ? (u32)(ctr >> 32) : kw;
  const u32 c0 = l == 0 ? (u32)ctr : l == 3 ? (u32)(nn >> 32) : kw;
  const u32 d0 = l == 2 ? (u32)nn : kw;
  u32 a = a0, bb = b0, c = c0, d = d0;
#pragma unroll UNROLL
  for (int i = 0; i < 10; ++i) {
    AB_QR(a, bb, c, d)
    u32 B = __shfl_sync(0xffffffffu, d, (l + 1) & 3, 4);
    u32 C = __shfl_sync(0xffffffffu, c, (l + 2) & 3, 4);
    u32 D = __shfl_sync(0xffffffffu, bb, (l + 3) & 3, 4);
    AB_QR(a, B, C, D)
    d = __shfl_sync(0xffffffffu, B, (l + 3) & 3, 4);
    c = __shfl_sync(0xffffffffu, C, (l + 2) & 3, 4);
    bb = __shfl_sync(0xffffffffu, D, (l + 1) & 3, 4);
  }
  if (b >= nb) return;
  u32* o = ks + (j * nb + b) * 16;
  o[(5 * l) & 15] = a + a0;
  o[(5 * l + 4) & 15] = bb + b0;
  o[(5 * l + 8) & 15] = c + c0;
  o[(5 * l + 12) & 15] = d + d0;
}

template <int ROT, int T>
static int ab_lean(bool carve, void* ks, long long nb, u32 kw,
                   const u64* nonces, int J, u64 nonce, u64 ctr0,
                   cudaStream_t st) {
  const AbMul m = {{1u, 1u << 7, 1u << 9, 1u << 13, 1u << 18}};
  cudaFuncSetAttribute(k_ab_salsa_lean<ROT, T>,
                       cudaFuncAttributePreferredSharedMemoryCarveout,
                       carve ? (int)cudaSharedmemCarveoutMaxShared
                             : (int)cudaSharedmemCarveoutDefault);
  const dim3 grid((unsigned)((nb + T - 1) / T), (unsigned)J);
  k_ab_salsa_lean<ROT, T><<<grid, T, 0, st>>>((uint4*)ks, nb, kw, nonces,
                                              nonce, ctr0, m);
  return (int)cudaGetLastError();
}

template <int ROT, int FORM, int UNROLL>
static void ab_launch(int threads, void* ks, long long nb, u32 kw,
                      const u64* nonces, int J, u64 nonce, u64 ctr0,
                      cudaStream_t st) {
  const AbMul m = {{1u, 1u << 7, 1u << 9, 1u << 13, 1u << 18}};
  const long long lanes = FORM == 3 ? 4 * nb : nb;
  const dim3 grid((unsigned)((lanes + threads - 1) / threads), (unsigned)J);
  if (FORM == 3)
    k_ab_salsa_lanes4<ROT, UNROLL><<<grid, threads, 0, st>>>(
        (u32*)ks, nb, kw, nonces, nonce, ctr0, m);
  else
    k_ab_salsa<ROT, FORM, UNROLL><<<grid, threads,
                                    FORM == 0 ? 0 : threads * 64, st>>>(
        (uint4*)ks, nb, kw, nonces, nonce, ctr0, m);
}

template <int ROT, int FORM>
static int ab_unroll(int unroll, int threads, void* ks, long long nb, u32 kw,
                     const u64* ns, int J, u64 nonce, u64 ctr0,
                     cudaStream_t st) {
  switch (unroll) {
    case 1: ab_launch<ROT, FORM, 1>(threads, ks, nb, kw, ns, J, nonce, ctr0, st); break;
    case 2: ab_launch<ROT, FORM, 2>(threads, ks, nb, kw, ns, J, nonce, ctr0, st); break;
    case 10: ab_launch<ROT, FORM, 10>(threads, ks, nb, kw, ns, J, nonce, ctr0, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// form 0-2 as k_ab_salsa's FORM, 3 the four-lane kernel, 4 the lean
// staged one (5: with the shared-memory carveout at its maximum); rot 0-2
// (2 only direct, 1 not warp-staged, 0 only for 4-5); unroll 1, 2 or 10
// (10 only for 4-5); threads 64 or 128 for 4-5
extern "C" int ab_salsa(int form, int rot, int unroll, int threads, void* ks,
                        long long nb, u32 kw, const void* nonces, int J,
                        u64 nonce, u64 ctr0, void* stream) {
  const u64* ns = (const u64*)nonces;
  cudaStream_t st = (cudaStream_t)stream;
  if (form == 4 || form == 5) {     // lean staged; 5 with the carveout hint
    if (rot != 0 || unroll != 10) return (int)cudaErrorInvalidValue;
    if (threads == 64)
      return ab_lean<0, 64>(form == 5, ks, nb, kw, ns, J, nonce, ctr0, st);
    if (threads == 128)
      return ab_lean<0, 128>(form == 5, ks, nb, kw, ns, J, nonce, ctr0, st);
    return (int)cudaErrorInvalidValue;
  }
#define AB_CASE(R, F)                                                    \
  if (rot == R && form == F)                                             \
    return ab_unroll<R, F>(unroll, threads, ks, nb, kw, ns, J, nonce, ctr0, st);
  AB_CASE(0, 0) AB_CASE(0, 1) AB_CASE(0, 2) AB_CASE(0, 3)
  AB_CASE(1, 0) AB_CASE(1, 1) AB_CASE(1, 3) AB_CASE(2, 0)
  return (int)cudaErrorInvalidValue;
}
"""


def start_build() -> tuple[subprocess.Popen, Path]:
    """The copy of csrc and ab.cu, built into a shared library and, with
    `-Xptxas -v`, a cubin for the variants' SASS."""
    out = ROOT / "build" / "salsa_ab"
    src = out / "src"
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(cuda.CSRC, src)
    (src / "ab.cu").write_text(AB_SRC)
    lib, cubin = out / "libsalsa_ab.so", out / "ab.cubin"
    nvcc = cuda.find_nvcc()
    cmd = (f"{nvcc} {' '.join(cuda.NVCC_FLAGS)} -shared -I {src} -o {lib} "
           f"{src / 'ab.cu'} && {nvcc} {' '.join(cuda.NVCC_FLAGS[:4])} "
           f"-Xptxas -v -cubin -I {src} -o {cubin} {src / 'ab.cu'}")
    return subprocess.Popen(["sh", "-c", cmd], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), lib


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def caller(lib, form: str, rot: int, unroll: int, threads: int, nb: int,
           kw: dict, dev):
    """A launch of one variant at a shape's keyword arguments, into its own
    output, returning it."""
    ns = (salsa20.nonce_tensor(kw["nonces"], dev) if "nonces" in kw
          else None)
    J = 1 if ns is None else ns.shape[0]
    out = torch.empty((J, 16 * nb) if ns is not None else (16 * nb,),
                      dtype=torch.int32, device=dev)
    key = salsa20._key_word(kw.get("key_byte", salsa20.DEFAULT_KEY_BYTE))

    def call():
        rc = lib.ab_salsa(FORMS[form], rot, unroll, threads, out.data_ptr(),
                          nb, key,
                          None if ns is None else ns.data_ptr(), J,
                          int(kw.get("nonce", 0)), int(kw.get("counter0", 0)),
                          stream())
        if rc != 0:
            raise RuntimeError(f"ab_salsa {form} rot {rot} unroll {unroll} "
                               f"{threads}: CUDA error {rc}")
        return out
    return call


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("tools/salsa_ab.py needs a CUDA card")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(cs.smi("name,power.limit"), flush=True)
    proc, path = start_build()
    out = cs.built(proc, "salsa A/B")
    lines = cs.ptxas_lines(out, "k_ab_salsa|k_salsa20")
    print(f"ptxas -v (k_ab_salsa<ROT, FORM, UNROLL>, k_ab_salsa_lean<ROT, "
          f"T>, k_ab_salsa_lanes4<ROT, UNROLL>, the library's k_salsa20 and "
          f"k_salsa20_lanes): {json.dumps(lines)}; with spills: "
          f"{json.dumps(cs.spills(lines))}", flush=True)
    cubin = path.with_name("ab.cubin")
    for kernel in ("k_salsa20", "k_salsa20_lanes", "k_ab_salsaILi0ELi0ELi10E",
                   "k_ab_salsaILi0ELi0ELi1E", "k_ab_salsaILi1ELi0ELi10E",
                   "k_ab_salsaILi0ELi1ELi10E", "k_ab_salsaILi0ELi2ELi10E",
                   "k_ab_salsa_leanILi0ELi128E", "k_ab_salsa_lanes4ILi0ELi10E",
                   "k_ab_salsa_lanes4ILi0ELi1E"):
        print(f"SASS by pipe, {kernel} (a thread): "
              f"{json.dumps(cs.sass_pipes(cubin, kernel))}", flush=True)
    ab = ctypes.CDLL(str(path))
    ab.ab_salsa.argtypes = [ctypes.c_int] * 4 + [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint32, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_void_p]
    ab.ab_salsa.restype = ctypes.c_int
    cases = {c[1]: c for c in cs.keystream_cases(dev)}
    shapes = {s[1]: s for s in cs.keystream_shapes()}
    res = {}
    for label in SHAPES:
        _, _, kern, plain, _ = cases[label]
        _, _, nb, kw = shapes[label]
        want = plain()
        calls = {"library": kern}
        for form, rot, u, t in VARIANTS:
            calls[f"{form} rot={rot} unroll={u} {t}"] = caller(
                ab, form, rot, u, t, nb, kw, dev)
        for name, call in calls.items():
            if not torch.equal(call(), want):
                raise AssertionError(f"{label} {name}: not the plain "
                                     f"version's stream")
        names = list(calls)
        row = {name: [] for name in names}
        for name in names + names[::-1]:
            row[name].append(device_us(calls[name], 10))
        res[label] = row
        print(f"{label}: {json.dumps(row)}", flush=True)
    print(json.dumps({"salsa_ab_us": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
