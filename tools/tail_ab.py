"""The encrypt tail's and kernel 17's design A/B, on one card.

    python3 tools/tail_ab.py

Builds csrc/fused_ops.cu and csrc/decrypt_tail.cu once more, into one
library under build/tail_ab, from a copy of csrc whose launch rules read
globals that this script sets: the encrypt tail (EncryptTail) at any G
lanes a coefficient, V coefficients a thread and block size, and kernel
17 (K2's kernel with the partial epilogue) at any G and block size; -1
and 0 keep the library's rule.  The build prints its `ptxas -v` lines.

Then at 32k_9q, the main paths' shapes: the encrypt tail as K5's and 13's
(J = 1 and 16, and J = 4 between), 19's drop, 14's (e added), 16's (rows 0-9 and 6-9) and
16's drop (the sharded key switch's constants), and kernel 17 at rows 0-9
and 6-9, levels 0 and 1.  Every variant's output is held against the
plain version (exact), and each variant's device us per call
(torch.profiler, 10 calls a window) is taken in turns library, variants,
variants reversed, library, where the library is the package's own
launch by the rule.  Prints the card's name and power limit, and one
JSON line.

Needs a CUDA card and raises without one.  Imports no jax.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke as cs  # noqa: E402
from behz_ab import patch, stream  # noqa: E402
from chip_smoke import device_us  # noqa: E402
from ntt_cuda_tpu_torch import cuda, get_bfv_params  # noqa: E402

SET = "32k_9q"
GS = (1, 2, 4, 8)
VS = (1, 2)
ENTRIES = ("ntt_encrypt_tail", "ntt_encrypt_tail_e",
           "ntt_encrypt_tail_padded", "ntt_drop_last_padded",
           "ntt_decrypt_tail_partial")
# the library's own choices: G and V by the rule, 128 threads a block for
# the encrypt tail and 256 for kernel 17
RULE = {"ab_et_lg": -1, "ab_et_v": 0, "ab_et_threads": 128, "ab_dt_lg": -1,
        "ab_dt_threads": 256}

AB_SRC = r"""
extern "C" {
int ab_et_lg = -1, ab_et_v = 0, ab_et_threads = 128;
int ab_dt_lg = -1, ab_dt_threads = 256;
}
#include "fused_ops.cu"
#include "decrypt_tail.cu"
"""


def start_build() -> tuple[subprocess.Popen, Path]:
    """The patched copy of csrc and its ab.cu, built with `-Xptxas -v`."""
    out = ROOT / "build" / "tail_ab"
    src = out / "src"
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(cuda.CSRC, src)
    f = src / "fused_ops.cu"
    text = patch(f.read_text(), r"ROWS < ET_MAX_ROWS\)", "ROWS < 16)", 1)
    text = patch(text, r"(\n  V = [^\n]*\n)",
                 r"\1  if (ab_et_lg >= 0) f.lg = ab_et_lg;\n"
                 r"  if (ab_et_v) V = ab_et_v;\n", 1)
    text = patch(text, r"__launch_bounds__\(ET_THREADS\)",
                 "__launch_bounds__(256)", 1)
    text = patch(text, r"\+ ET_THREADS - 1\) / ET_THREADS",
                 "+ ab_et_threads - 1) / ab_et_threads", 1)
    text = patch(text, r"<<<grid, ET_THREADS, 0,", "<<<grid, ab_et_threads, 0,",
                 1)
    f.write_text(text)
    d = src / "decrypt_tail.cu"
    text = patch(d.read_text(), r"inv_gt, dt_lg\(rk\)\}",
                 "inv_gt, ab_dt_lg >= 0 ? ab_dt_lg : dt_lg(rk)}", 1)
    text = patch(text, r"\+ DT_THREADS - 1\) / DT_THREADS",
                 "+ ab_dt_threads - 1) / ab_dt_threads", 1)
    text = patch(text, r"<<<grid, DT_THREADS, 0,",
                 "<<<grid, ab_dt_threads, 0,", 1)
    text = patch(text, r"__launch_bounds__\(DT_THREADS\)",
                 "__launch_bounds__(1024)", 1)
    d.write_text(text)
    (src / "ab.cu").write_text(AB_SRC)
    lib = out / "libtail_ab.so"
    return subprocess.Popen(
        [cuda.find_nvcc(), *cuda.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
         "-I", str(src), "-o", str(lib), str(src / "ab.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib


def load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for name in ENTRIES:
        fn = getattr(lib, name)
        fn.argtypes = list(cuda.SIGNATURES[name])
        fn.restype = ctypes.c_int
    return lib


def caller(lib, knobs: dict, entry: str, args: tuple, out):
    """A call of `entry` on `lib` with the A/B library's globals set to
    `knobs` (the library itself has none), returning out.  args holds raw
    pointers: the case keeps their tensors alive."""
    def call():
        for k, v in knobs.items():
            ctypes.c_int.in_dll(lib, k).value = v
        rc = getattr(lib, entry)(*args, stream())
        if rc != 0:
            raise RuntimeError(f"{entry} {knobs}: CUDA error {rc}")
        return out
    return call


def turns(calls: dict, out: torch.Tensor, want: torch.Tensor) -> dict:
    """Each call's output (out, cleared first) held against want, then
    device us per call in turns library, the rest, the rest reversed,
    library."""
    for label, call in calls.items():
        out.fill_(-1)
        if not torch.equal(call(), want):
            raise AssertionError(f"{label}: not the plain version's integers")
    names = list(calls)
    row = {label: [] for label in names}
    for label in names + names[::-1]:
        row[label].append(device_us(calls[label], 10))
    return row


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("tools/tail_ab.py needs a CUDA card")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(cs.smi("name,power.limit"), flush=True)
    proc, path = start_build()
    lib = cuda.library()
    lines = cs.ptxas_lines(cs.built(proc, "tail A/B"),
                           "k_encrypt_tail|k_decrypt_tail")
    print(f"ptxas -v (k_encrypt_tail<ROWS, V> up to 16 rows, "
          f"k_decrypt_tail<ROWS, PARTIAL>): {json.dumps(lines)}; with "
          f"spills: {json.dumps(cs.spills(lines))}", flush=True)
    ab = load(path)
    p = get_bfv_params(SET)
    rng = np.random.default_rng(cs.SEED)
    res = {}
    for label, entry, args, out, want, *_ in cs.tail_cases(
            p, dev, rng, (1, 4, cs.BATCH_J)):
        calls = {"library": caller(lib, {}, entry, args, out),
                 "rule (A/B build)": caller(ab, RULE, entry, args, out)}
        for G in GS:
            for V in VS:
                calls[f"G={G} V={V}"] = caller(
                    ab, {**RULE, "ab_et_lg": G.bit_length() - 1,
                         "ab_et_v": V}, entry, args, out)
        for T in (64, 256):
            calls[f"rule, {T} threads a block"] = caller(
                ab, {**RULE, "ab_et_threads": T}, entry, args, out)
        row = turns(calls, out, want)
        res[label] = row
        print(f"{label}: {json.dumps(row)}", flush=True)
    for label, entry, args, out, want, *_ in cs.partial_cases(p, dev, rng):
        calls = {"library": caller(lib, {}, entry, args, out),
                 "rule (A/B build)": caller(ab, RULE, entry, args, out)}
        for G in GS:
            calls[f"G={G}"] = caller(
                ab, {**RULE, "ab_dt_lg": G.bit_length() - 1}, entry, args,
                out)
        for T in (64, 128, 512, 1024):
            calls[f"rule, {T} threads a block"] = caller(
                ab, {**RULE, "ab_dt_threads": T}, entry, args, out)
        row = turns(calls, out, want)
        res[label] = row
        print(f"{label}: {json.dumps(row)}", flush=True)
    print(json.dumps({"tail_ab_us": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
