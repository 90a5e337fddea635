"""The cluster kernels' __launch_bounds__ A/B at cluster size 8, on one card.

    python3 tools/bounds_ab.py

Builds csrc/ntt_stage.cu and csrc/fused_ops.cu twice more, each into a
library of its own under build/bounds_ab, from a copy of csrc whose
ntt_cluster.cuh has ClusterBound and wide_occ replaced:

* `one`: `__launch_bounds__(512, 1)` at every grid (wide_occ 1), where the
  library takes `(512, 2)` for a grid of more clusters than the card holds
  at once;
* `1024`: `__launch_bounds__(1024)`, the bound before ClusterBound.

A stage launch of more clusters than the card holds runs the stage engine
(ntt_stage.cu) in every build: its bounds are its own, and the forms
change only the other kernels and the narrower launches.

All three builds print their cluster kernels' `ptxas -v` lines.  Then every
CL = 3 kernel runs at B = 8 at the main paths' shapes and between them
(`cases`): each build's outputs equal to the plain versions, and device us
per launch (torch.profiler) in turns library, one, 1024, 1024, one,
library.  Prints the card's name and power limit, and one JSON line.

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
from chip_smoke import device_us, rand_res, raw_launch, tables  # noqa: E402
from ntt_cuda_tpu_torch import cuda, get_bfv_params  # noqa: E402
from ntt_cuda_tpu_torch.ops import (fused_ops, ntt, ntt_stage,  # noqa: E402
                                    sampling)

# each form's ClusterBound body and wide_occ body
FORMS = {
    "one": (None, "return 1;"),
    "1024": ("static constexpr int threads = 1024;\n"
             "  static constexpr int blocks = 1;", "return 1;"),
}
ENTRIES = ("ntt_stage_forward_cluster", "ntt_stage_inverse_cluster",
           "ntt_half_polymul_cluster", "ntt_keygen_fused_cluster",
           "ntt_encrypt_transform_cluster")


def patch(text: str, pattern: str, body: str | None) -> str:
    """`text` with the one brace body after `pattern` replaced by `body`."""
    hits = list(re.finditer(pattern + r"\s*\{(.*?)\n?\}", text, re.S))
    if len(hits) != 1:
        raise RuntimeError(f"ntt_cluster.cuh: {len(hits)} matches of "
                           f"{pattern!r}, expected 1")
    if body is None:
        return text
    m = hits[0]
    return text[:m.start(1)] + "\n  " + body + "\n" + text[m.end(1):]


def start_builds() -> dict[str, tuple[subprocess.Popen, Path]]:
    """The library's sources and each form's copy, with `-Xptxas -v`, all
    started together."""
    out = ROOT / "build" / "bounds_ab"
    res = {}
    for form, (bound, occ) in [("library", (None, None)), *FORMS.items()]:
        src = cuda.CSRC
        if form != "library":
            src = out / form
            shutil.rmtree(src, ignore_errors=True)
            shutil.copytree(cuda.CSRC, src)
            h = src / "ntt_cluster.cuh"
            text = patch(h.read_text(), r"struct ClusterBound", bound)
            h.write_text(patch(text, r"constexpr int wide_occ\(int cl\)",
                               occ))
        out.mkdir(parents=True, exist_ok=True)
        lib = out / f"lib{form}.so"
        res[form] = (subprocess.Popen(
            [cuda.find_nvcc(), *cuda.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
             "-o", str(lib), str(src / "ntt_stage.cu"),
             str(src / "fused_ops.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    return res


def cases(dev, rng) -> list:
    """(label, entry point, its arguments before B, tensors standing for
    their pointers, outputs, plain results) of every CL = 3 kernel:
    kernels 7 (forward) and 8 (inverse with y) over P = 9, 18 and 72
    polynomials at 32k_9q (72: the key switch's digit forward); K5's
    transform at 16k_5q J = 1, 16 and 32k_9q J = 1, 2, 16 (16: the batch
    path); K3 at J = 1 and 3 and K4 at 16k_5q, 32k_9q and 32k_16q."""
    res = []
    p = get_bfv_params("32k_9q")
    tb = ntt.tables_for(p, device=dev)
    for J in (1, 2, 8):
        x, y = (rand_res(rng, p.q, p.n, (J,), dev) for _ in range(2))
        o7, o8 = torch.empty_like(x), torch.empty_like(x)
        P = J * p.r
        res += [
            (f"7 fwd 32k_9q P={P}", ENTRIES[0],
             (x, None, None, None, o7, *tables(tb), cuda.PRO_COPY, P, p.r,
              p.logn, None, 0, 0),
             (o7,), (ntt_stage.ntt_forward_plain(x, tb),)),
            (f"8 32k_9q P={P}", ENTRIES[1],
             (x, y, None, o8, *tables(tb), cuda.PRO_MONT, P, P, p.r, p.logn,
              None, 0, 0),
             (o8,), (ntt_stage.ntt_inverse_mul_plain(x, y, tb),))]
    for name, Js in (("16k_5q", (1, 16)), ("32k_9q", (1, 2, 16)),
                     ("32k_16q", ())):
        p = get_bfv_params(name)
        tf = ntt.tables_for(p, device=dev)
        td = ntt.tables_for(p, p.r - 1, device=dev)
        pk = rand_res(rng, p.q, p.n, (2,), dev)
        for J in Js:
            u_b, e2 = sampling.encrypt_draws_compact_batch(
                p.n, range(1, J + 1), device=dev)
            o5 = torch.empty((J, 2, p.r, p.n), dtype=torch.int64, device=dev)
            res.append(
                (f"K5 transform {name} J={J}", ENTRIES[4],
                 (u_b, pk, e2, o5, *tables(tf), J, p.r, p.logn), (o5,),
                 (fused_ops.encrypt_transform_plain(u_b, pk, e2, tf),)))
        yd = rand_res(rng, p.q[:-1], p.n, (), dev)
        for J in (1, 3):
            xd = rand_res(rng, p.q[:-1], p.n, (J,), dev)
            o3 = torch.empty_like(xd)
            res.append((f"K3 {name} J={J}", ENTRIES[2],
                        (xd, yd, o3, *tables(td), J * td.r, td.r, p.logn),
                        (o3,), (fused_ops.half_polymul_plain(xd, yd, td),)))
        s_b, a, e_d = sampling.keygen_draws_compact(p.n, p.r, tf.ms, nonce=1)
        sk, pk0 = torch.empty_like(a), torch.empty_like(a)
        res.append((f"K4 {name}", ENTRIES[3],
                    (s_b, a, e_d, sk, pk0, *tables(tf), p.r, p.logn),
                    (sk, pk0), fused_ops.keygen_fused_plain(s_b, a, e_d, tf)))
    return res


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("tools/bounds_ab.py needs a CUDA card")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(cs.smi("name,power.limit"), flush=True)
    libs = {}
    for form, (proc, path) in start_builds().items():
        lines = cs.ptxas_lines(cs.built(proc, f"bounds A/B {form}"),
                               cs.CLUSTER_KERNELS)
        print(f"ptxas -v, form {form!r}: {json.dumps(lines)}", flush=True)
        libs[form] = ctypes.CDLL(str(path))
        for entry in ENTRIES:
            fn = getattr(libs[form], entry)
            fn.argtypes = list(cuda.SIGNATURES[entry])
            fn.restype = ctypes.c_int
    res = {}
    for label, entry, args, outs, refs in cases(
            dev, np.random.default_rng(cs.SEED)):
        ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a
                for a in args]
        calls = {}
        for form, lib in libs.items():
            def call(lib=lib):
                raw_launch(lib, entry, *ptrs, 8)
            call()
            if not all(torch.equal(o, r) for o, r in zip(outs, refs)):
                raise AssertionError(f"{label} ({form}): not the plain "
                                     f"version's integers")
            for o in outs:
                o.zero_()
            calls[form] = call
        row, names = {form: [] for form in libs}, set()
        for form in list(libs) + list(reversed(libs)):
            row[form].append(device_us(
                calls[form], names=names if form == "library" else None))
        row["library_kernels"] = sorted(names)
        res[label] = row
        print(f"{label}: {json.dumps(row)}", flush=True)
    print(json.dumps({"bounds_ab_us": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
