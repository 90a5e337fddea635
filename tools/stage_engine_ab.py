"""Device time of the stage transform at the server cells' launch widths.

    python3 tools/stage_engine_ab.py [--root DIR] [--paths] [--reps N]

Imports ntt_cuda_tpu_torch from DIR (default: this checkout; a `git
archive` of another commit under a directory .gitignore lists, say) and
runs, for each server cell, the six stage launches of one request: the
product's forwards and inverses over q and over Bsk (PRO_COPY, PRO_MONT)
and the key switch's PRO_DIGIT forward and PRO_KSACC inverse, at the
cell's J, through the launchers' rule.  For each: us a launch (REPS
launches back to back between CUDA events, after one more) and a digest
of its output, whose inputs come from one seed in every checkout.  With
--paths (a checkout with the engine's entry points) each launch also runs
on the engine and on the kernel of OCC = 1 alone, both outputs held equal
to the rule's.  Prints the card's name and power limit, then one JSON
line.  Needs a CUDA card; imports no jax.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

# cell: (parameter set, J)
CELLS = {"32k_9q.mulrelin": ("32k_9q", 8),
         "32k_16q.mulrelin": ("32k_16q", 4),
         "16k_5q.mulrelin": ("16k_5q", 16)}
PATHS = {"engine": 0, "one": -1}


def rand_res(rng, tables, lead, dev) -> torch.Tensor:
    qs = [int(q) for q in tables.ms.q.flatten()]
    return torch.from_numpy(np.stack(
        [rng.integers(0, q, lead + (tables.n,)) for q in qs],
        axis=-2)).to(dev)


def cases(p, J: int, dev, rng) -> list:
    """(name, direction, out, the _cluster entry's arguments before the
    last) of one request's six stage launches."""
    from ntt_cuda_tpu_torch import cuda
    from ntt_cuda_tpu_torch.models.bfv import BFVContext

    ctx = BFVContext.build(p, device=dev)
    tq, tf = ctx.tables_drop, ctx.tables_full
    tb = ctx._mult_setup().tables_bsk
    n, r, k = p.n, p.r, p.r - 1
    res = []
    for label, t in (("q", tq), ("bsk", tb)):
        x = rand_res(rng, t, (4 * J,), dev)
        y = rand_res(rng, t, (4 * J,), dev)
        P = x.numel() // n
        res.append((f"fwd_{label}", "forward", torch.empty_like(x),
                    lambda o, x=x, t=t, P=P: (
                        x.data_ptr(), None, None, None, o.data_ptr(),
                        *t.kernel_args(), cuda.PRO_COPY, P, t.r, p.logn,
                        None, 0, 0)))
        res.append((f"inv_{label}", "inverse", torch.empty_like(x),
                    lambda o, x=x, y=y, t=t, P=P: (
                        x.data_ptr(), y.data_ptr(), None, o.data_ptr(),
                        *t.kernel_args(), cuda.PRO_MONT, P, P, t.r, p.logn,
                        None, 0, 0)))
    c2 = torch.from_numpy(rng.integers(0, max(p.q), (J * k, n))).to(dev)
    dhat = torch.empty((J, k, r, n), dtype=torch.int64, device=dev)
    ksk = rand_res(rng, tf, (2, k), dev)
    res.append(("fwd_ks", "forward", dhat,
                lambda o: (c2.data_ptr(), None, None,
                           tf.ms.nu.data_ptr(), o.data_ptr(),
                           *tf.kernel_args(), cuda.PRO_DIGIT, J * k * r, r,
                           p.logn, None, 0, 0)))
    res.append(("inv_ks", "inverse",
                torch.empty((J, 2, r, n), dtype=torch.int64, device=dev),
                lambda o: (dhat.data_ptr(), ksk.data_ptr(), None,
                           o.data_ptr(), *tf.kernel_args(), cuda.PRO_KSACC, k,
                           J * 2 * r, r, p.logn, None, 0, 0)))
    return res


def time_us(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) * 1e3 / reps


def digest(t: torch.Tensor) -> str:
    return hashlib.sha1(t.cpu().numpy().tobytes()).hexdigest()[:12]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                    help="the checkout whose ntt_cuda_tpu_torch to import")
    ap.add_argument("--paths", action="store_true",
                    help="also the engine and the kernel of OCC = 1 alone")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    from ntt_cuda_tpu_torch import cuda, get_bfv_params

    if not torch.cuda.is_available():
        raise RuntimeError("stage_engine_ab.py needs a CUDA card")
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    out = {"root": args.root, "cells": {}}
    for cell, (name, J) in CELLS.items():
        p = get_bfv_params(name)
        rows = {}
        for label, way, o, argv in cases(p, J, dev,
                                         np.random.default_rng(24)):
            a = argv(o)
            rule = lambda: cuda.launch(f"ntt_stage_{way}_cluster", dev, *a, 0)
            row = {"P": a[11], "rule_us": time_us(rule, args.reps)}
            ref = o.clone()
            row["digest"] = digest(ref)
            if args.paths:
                for path, v in PATHS.items():
                    fn = lambda v=v: cuda.launch(f"ntt_stage_{way}_engine",
                                                 dev, *a, v)
                    o.zero_()
                    row[f"{path}_us"] = time_us(fn, args.reps)
                    row[f"{path}_equal"] = bool(torch.equal(o, ref))
            rows[label] = row
            print(cell, label, json.dumps(row), flush=True)
        out["cells"][cell] = rows
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
