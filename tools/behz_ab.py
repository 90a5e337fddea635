"""The BEHZ conversions' and K2's design A/B, on one card.

    python3 tools/behz_ab.py

Builds csrc/behz.cu and csrc/decrypt_tail.cu twice more, each into a
library of its own under build/behz_ab, from a copy of csrc with
BEHZ_MAX_GROUP raised to 8 and, beside each copy, an entry point
`ab_behz` that takes any group size G and either schedule of the
prescaled residues (SHARE: one shared exchange, or every member
prescaling all k sources itself):

* `exact`: the library's inner products (exact 128-bit sums reduced once
  a target);
* `canonical`: every term a Shoup product added canonically (Lin replaced).

The `exact` copy also holds K2's variants: `ab_dt` (any G, blocks of any
multiple of 32 threads), `ab_dt_multi` (V coefficients a thread, every
row's loads issued before its products) and `ab_empty` (an empty launch).
Both builds print their `ptxas -v` lines.

Then at 4k_3q, 16k_5q, 32k_9q and 32k_16q (J = 1; K2 also J = 3) every
variant's output is held against the plain version (exact), and each
variant's device us per call (torch.profiler, 10 calls a window) is
taken in turns library, variants, variants reversed, library, where the
library is the package's own wrappers (the launchers' rule).  Prints the
card's name and power limit, and one JSON line.

Needs a CUDA card and raises without one.  Imports no jax.
"""

from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from chip_smoke import device_us, rand_res  # noqa: E402
from ntt_cuda_tpu_torch import cuda, get_bfv_params  # noqa: E402
from ntt_cuda_tpu_torch.ops import behz, behz_kernels, bfv_tail  # noqa: E402

SETS = ("4k_3q", "16k_5q", "32k_9q", "32k_16q")
GS = (1, 2, 4, 8)
DT_VS = (2, 4)
DT_BLOCKS = (64, 128)

CANONICAL_LIN = """struct Lin {
  u64 s = 0;
  BEHZ_HD void add(u64 x, const u64* c, u64 m) {
    s = add_mod(s, mul_shoup(x, c[0], c[1], m), m);
  }
  BEHZ_HD u64 mod(u64, const u64*) const { return s; }
};"""

AB_SRC = r"""
#include "behz.cu"
#include "decrypt_tail.cu"
extern "C" int ab_behz(int which, const void* x, const void* xb, void* out,
                       const void* qsrc, const void* tgt, const void* amat,
                       const void* bsrc, const void* bmat, const void* bfin,
                       const void* glob, int C, int k, int n, int row0,
                       int rl, int group, int share, void* stream) {
  const int lg = behz_lg(group);
  if (!behz_args_ok(which, xb, C, k, n, row0, rl, lg)) return BEHZ_BAD_ARGS;
  const BehzIO io = behz_io(x, xb, out, qsrc, tgt, amat, bsrc, bmat, bfin,
                            glob, k, n, row0, rl, lg);
  return share ? behz_launch<true>(which, io, C, (cudaStream_t)stream)
               : behz_launch<false>(which, io, C, (cudaStream_t)stream);
}
#ifdef AB_K2
template <int ROWS>
static void ab_dt_run(const DtArgs& a, cudaStream_t s, int threads) {
  const dim3 grid(
      (unsigned)((((long long)a.n << a.lg) + threads - 1) / threads),
      (unsigned)a.J);
  k_decrypt_tail<ROWS, false><<<grid, threads, 0, s>>>(a);
}
template <int ROWS = 1>
static void ab_dt_dispatch(const DtArgs& a, cudaStream_t s, int threads) {
  const int G = 1 << a.lg;
  if ((a.rk + G - 1) / G <= ROWS || ROWS == DT_MAX_ROWS)
    ab_dt_run<ROWS>(a, s, threads);
  else if constexpr (ROWS < DT_MAX_ROWS)
    ab_dt_dispatch<ROWS + 1>(a, s, threads);
}
// K2 at G lanes a coefficient (0: the rule) in blocks of `threads`.
extern "C" int ab_dt(int group, int threads, const void* x, const void* c0,
                     void* out, const void* kr, const void* gl, int J,
                     int rk, int n, int pow2, u64 t, u64 neg_t, u64 nu_t,
                     u64 inv_gt, void* stream) {
  DtArgs a;
  if (!dt_args(x, c0, out, kr, gl, J, rk, n, pow2, t, neg_t, nu_t, inv_gt, a)
      || threads % 32 || threads < 32 || threads > DT_THREADS)
    return (int)cudaErrorInvalidValue;
  if (group) {
    a.lg = behz_lg(group);
    if (a.lg < 0 || group > 32 || rk > DT_MAX_ROWS * group)
      return (int)cudaErrorInvalidValue;
  }
  ab_dt_dispatch(a, (cudaStream_t)stream, threads);
  return (int)cudaGetLastError();
}
template <int V>
__global__ void __launch_bounds__(256) k_dt_multi(
    const u64* x, const u64* c0, u64* out, const u64* kr, const u64* gl,
    int rk, int n, int pow2, u64 t, u64 neg_t, u64 nu_t, u64 inv_gt) {
  const int k0 = blockIdx.x * 256 * V + threadIdx.x;
  const size_t j = blockIdx.y;
  BehzSums acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = {0, 0};
  for (int i = 0; i < rk; ++i) {
    const u64* r = kr + 6 * i;
    u64 xs[V], cs[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int k = k0 + 256 * v;
      const size_t off = (j * rk + i) * n + k;
      xs[v] = k < n ? x[off] : 0;
      cs[v] = k < n ? c0[off] : 0;
    }
#pragma unroll
    for (int v = 0; v < V; ++v)
      behz_row_shoup(acc[v], xs[v], cs[v], r, gl[0], pow2, t, nu_t);
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int k = k0 + 256 * v;
    if (k < n)
      out[j * n + k] = dec_round(acc[v], gl, pow2, t, neg_t, nu_t, inv_gt);
  }
}
// K2 with V coefficients a thread.
extern "C" int ab_dt_multi(int V, int, const void* x, const void* c0,
                           void* out, const void* kr, const void* gl, int J,
                           int rk, int n, int pow2, u64 t, u64 neg_t,
                           u64 nu_t, u64 inv_gt, void* stream) {
  const dim3 grid((unsigned)((n + 256 * V - 1) / (256 * V)), (unsigned)J);
  cudaStream_t s = (cudaStream_t)stream;
  const u64 *a = (const u64*)x, *b = (const u64*)c0, *r = (const u64*)kr,
            *g = (const u64*)gl;
  u64* o = (u64*)out;
  if (V == 2)
    k_dt_multi<2><<<grid, 256, 0, s>>>(a, b, o, r, g, rk, n, pow2, t, neg_t,
                                       nu_t, inv_gt);
  else if (V == 4)
    k_dt_multi<4><<<grid, 256, 0, s>>>(a, b, o, r, g, rk, n, pow2, t, neg_t,
                                       nu_t, inv_gt);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
__global__ void k_empty() {}
extern "C" int ab_empty(void* stream) {
  k_empty<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
#endif
"""


def patch(text: str, old: str, new: str, count: int) -> str:
    """`text` with the `count` matches of regex `old` replaced by `new`."""
    res, n = re.subn(old, new, text, flags=re.S)
    if n != count:
        raise RuntimeError(f"behz.cu: {n} matches of {old!r}, expected "
                           f"{count}")
    return res


def start_builds() -> dict[str, tuple[subprocess.Popen, Path]]:
    """Each form's patched copy of csrc and its ab.cu, with `-Xptxas -v`,
    both started together."""
    out = ROOT / "build" / "behz_ab"
    res = {}
    for form in ("exact", "canonical"):
        src = out / form
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(cuda.CSRC, src)
        h = src / "behz.cu"
        text = patch(h.read_text(), r"#define BEHZ_MAX_GROUP 2\n",
                     "#define BEHZ_MAX_GROUP 8\n", 1)
        if form == "canonical":
            text = patch(text, r"struct Lin \{.*?\n\};", CANONICAL_LIN, 1)
            # the modulus of each sum: m in lin<K>, m_sk everywhere else
            text = patch(text, r"\bacc\.add\(([^;]*)\);", r"acc.add(\1, m);",
                         2)
            text = patch(text, r"\b(part|a)\.add\(([^;]*)\);",
                         r"\1.add(\2, msk);", 7)
        h.write_text(text)
        (src / "ab.cu").write_text(
            ("#define AB_K2 1\n" if form == "exact" else "") + AB_SRC)
        lib = out / f"lib{form}.so"
        res[form] = (subprocess.Popen(
            [cuda.find_nvcc(), *cuda.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
             "-I", str(src), "-o", str(lib), str(src / "ab.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    return res


def load(path: Path, k2: bool) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.ab_behz.argtypes = list(cuda.SIGNATURES["ntt_behz"][:-1]) + [
        ctypes.c_int, ctypes.c_void_p]
    fns = [lib.ab_behz]
    if k2:
        dt = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
              + [ctypes.c_uint64] * 4 + [ctypes.c_void_p])
        lib.ab_dt.argtypes = lib.ab_dt_multi.argtypes = dt
        lib.ab_empty.argtypes = [ctypes.c_void_p]
        fns += [lib.ab_dt, lib.ab_dt_multi, lib.ab_empty]
    for fn in fns:
        fn.restype = ctypes.c_int
    return lib


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def conversions(p, dev, rng) -> list:
    """(name, library call, plain result, raw args) of 21a, 21b, 21c and
    scale_and_round at p, J = 1, at the EvalMult path's shapes; raw args
    (which, x, xb, out, C, rl) run the same conversion through ab_behz."""
    k, n = p.r - 1, p.n
    aux = behz.AuxBase.build(p)
    mb = behz_kernels.MultBanks.build(p, aux, dev)
    bk = behz_kernels
    xa = rand_res(rng, p.q[:k], n, (2, 2), dev)
    xq = rand_res(rng, p.q[:k], n, (3,), dev)
    xb = rand_res(rng, aux.bsk, n, (3,), dev)
    res = []
    for name, which, fn, plain, x, y, rows, C in (
            ("21a", bk.RNS_TO_BSK, bk.rns_to_bsk, bk.rns_to_bsk_plain, xa,
             None, k + 1, 4),
            ("21b", bk.FAST_FLOOR, bk.fast_floor, bk.fast_floor_plain, xq,
             xb, k + 1, 3),
            ("21c", bk.BSK_TO_Q, bk.bsk_to_q, bk.bsk_to_q_plain, xb, None, k,
             3),
            ("scale_and_round", bk.SCALE_AND_ROUND, bk.scale_and_round,
             bk.scale_and_round_plain, xq, xb, k, 3)):
        args = (x,) if y is None else (x, y)
        out = torch.empty((C, rows, n), dtype=torch.int64, device=dev)
        res.append((name, lambda f=fn, a=args: f(*a, mb), plain(*args, mb),
                    (which, x, y, out, mb, C, rows)))
    return res


def ab_behz_call(lib, raw, G: int, share: int):
    which, x, y, out, mb, C, rows = raw
    n = x.shape[-1]

    def call():
        rc = lib.ab_behz(which, x.data_ptr(),
                         None if y is None else y.data_ptr(), out.data_ptr(),
                         *mb.kernel_args(), C, mb.k, n, 0, rows, G, share,
                         stream())
        if rc != 0:
            raise RuntimeError(f"ab_behz: CUDA error {rc}")
        return out.reshape(x.shape[:-2] + out.shape[-2:])
    return call


def ab_dt_call(lib, fn: str, a: int, b: int, x, c0, dt):
    J, rk, n = x.shape
    out = torch.empty((J, n), dtype=torch.int64, device=x.device)

    def call():
        rc = getattr(lib, fn)(a, b, x.data_ptr(), c0.data_ptr(),
                             out.data_ptr(), dt.k2_rows.data_ptr(),
                             dt.glob.data_ptr(), J, rk, n,
                             *bfv_tail._t_strategy(dt.tmeta), stream())
        if rc != 0:
            raise RuntimeError(f"{fn}: CUDA error {rc}")
        return out
    return call


def turns(calls: dict, ref) -> dict:
    """Each call's output held against ref, then device us per call in
    turns library, the rest, the rest reversed, library."""
    for label, call in calls.items():
        if not torch.equal(call(), ref):
            raise AssertionError(f"{label}: not the plain version's integers")
    names = list(calls)
    row = {label: [] for label in names}
    for label in names + names[::-1]:
        row[label].append(device_us(calls[label], 10))
    return row


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("tools/behz_ab.py needs a CUDA card")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(cs.smi("name,power.limit"), flush=True)
    builds = start_builds()
    cuda.library()
    libs = {}
    for form, (proc, path) in builds.items():
        lines = cs.ptxas_lines(cs.built(proc, f"behz A/B {form}"),
                               "k_behz|k_decrypt_tail|k_dt_multi")
        print(f"ptxas -v, form {form!r}: {json.dumps(lines)}; with spills: "
              f"{json.dumps(cs.spills(lines))}", flush=True)
        libs[form] = load(path, form == "exact")
    ex, ca = libs["exact"], libs["canonical"]
    rng = np.random.default_rng(cs.SEED)
    res = {"empty launch": [device_us(lambda: ex.ab_empty(stream()), 10)
                            for _ in range(3)]}
    for name in SETS:
        p = get_bfv_params(name)
        for label, lib_call, ref, raw in conversions(p, dev, rng):
            calls = {"library": lib_call}
            for G in GS:
                calls[f"G={G}"] = ab_behz_call(ex, raw, G, int(G > 1))
            for G in (1, 2):
                calls[f"G={G} share={int(G == 1)}"] = ab_behz_call(
                    ex, raw, G, int(G == 1))
                calls[f"G={G} canonical"] = ab_behz_call(ca, raw, G,
                                                          int(G > 1))
            row = turns(calls, ref)
            res[f"{label} {name} J=1"] = row
            print(f"{label} {name}: {json.dumps(row)}", flush=True)
        k = p.r - 1
        dt = bfv_tail.DecTailConsts.build(p, dev)
        for J in (1, 3):
            x = rand_res(rng, p.q[:k], p.n, (J,), dev)
            c0 = rand_res(rng, p.q[:k], p.n, (J,), dev)
            calls = {"library": lambda x=x, c0=c0: bfv_tail.decrypt_tail(
                x, c0, dt)}
            for G in GS:
                calls[f"G={G}"] = ab_dt_call(ex, "ab_dt", G, 256, x, c0, dt)
            for T in DT_BLOCKS:
                calls[f"rule, {T} threads a block"] = ab_dt_call(
                    ex, "ab_dt", 0, T, x, c0, dt)
            for V in DT_VS:
                calls[f"V={V}"] = ab_dt_call(ex, "ab_dt_multi", V, 0, x, c0,
                                             dt)
            row = turns(calls, bfv_tail.decrypt_tail_plain(x, c0, dt))
            res[f"K2 {name} J={J}"] = row
            print(f"K2 {name} J={J}: {json.dumps(row)}", flush=True)
    print(json.dumps({"behz_ab_us": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
