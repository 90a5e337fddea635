"""Where the time of each BFV op of the PyTorch/CUDA port goes, on one card.

    python3 tools/profile_ops.py [--set 32k_9q] [--fusion auto] [--reps 30]
                                 [--ops keygen,encrypt,...] [--spmd]

For keygen, encrypt, decrypt, decrypt_batch (J = 3), encrypt_batch
(J = 16, nonces 1..16), the EvalMult ops (mul, mul with
relinearization, relin_keygen, relinearize), apply_galois (g = 3) and
decrypt's back half on x = NTT(c1) (`decrypt_back_15`: kernel 15;
`decrypt_back_8_K2`: kernel 8 + K2, as `BFVContext.decrypt` runs it) of
one parameter set, through `BFVContext` (`--ops` picks some of them), or
with `--spmd` for keygen, encrypt, decrypt and mod_switch_to_next through
the RNS-sharded `SpmdBFVContext` and mul, relinearize and apply_galois
(g = 3) through its `SpmdMultContext`, and keygen, encrypt and decrypt
through the 2-D `Spmd2DBFVContext` (`keygen_2d`, ...; mesh (1, 1)), at
world size 1 over NCCL, prints one JSON line per op:

* `event_ms`: median CUDA-event time around one call;
* `sync_wall_ms`: median host time of one call ending in
  `torch.cuda.synchronize()` (no profiler running);
* under `torch.profiler` over `--reps` calls: `kernels_per_call` (CUDA
  kernels and copies), `busy_us` (the union of their device intervals, per
  call), `port_kernels_us` (the csrc kernels, `k_*`, by name, per call;
  fused_ops.cu's kernels carry the op's struct as a template argument),
  `idle_share` = 1 - busy / sync wall, and `host_top_us`: the eight host
  events (PyTorch ops and CUDA runtime calls) with the most self time,
  per call.

Needs a CUDA card and raises without one.  Imports no jax.
"""

from __future__ import annotations

import argparse
import collections
import json
import socket
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from ntt_cuda_tpu_torch import BFVContext, get_bfv_params  # noqa: E402
from ntt_cuda_tpu_torch.ops import bfv_tail, ntt_stage  # noqa: E402
from ntt_cuda_tpu_torch.parallel import (multihost, spmd,  # noqa: E402
                                         spmd2d, spmd_mult)


def device_intervals(prof) -> list[tuple[float, float, str]]:
    """(start us, end us, name) of every device event of a profile."""
    return [(e.time_range.start, e.time_range.end, e.name)
            for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def union_us(iv) -> float:
    total, end = 0.0, float("-inf")
    for s, e, _ in sorted(iv):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def event_ms(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def wall_ms(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--set", default="32k_9q")
    ap.add_argument("--fusion", default="auto")
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--ops", default="",
                    help="comma-separated op names (default: all)")
    ap.add_argument("--spmd", action="store_true",
                    help="the sharded programs at world size 1 (NCCL)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("profile_ops.py needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    p = get_bfv_params(args.set)
    msgs = np.random.default_rng(1).integers(0, p.t, (16, p.n))
    fusion, ops = (spmd_ops(p, msgs) if args.spmd
                   else bfv_ops(p, args.fusion, msgs))
    if args.ops:
        ops = {k: ops[k] for k in args.ops.split(",")}
    for name, fn in ops.items():
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        row = {"set": args.set, "fusion": fusion, "op": name,
               "event_ms": event_ms(fn, args.reps),
               "sync_wall_ms": wall_ms(fn, args.reps)}
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(args.reps):
                fn()
            torch.cuda.synchronize()
        iv = device_intervals(prof)
        if not iv:
            row["profiler"] = "no device events: not measured"
        else:
            busy = union_us(iv) / args.reps
            port = collections.Counter()
            for s, e, n in iv:
                n = n.split("(")[0].removeprefix("void ")
                if n.startswith("k_"):
                    port[n] += (e - s) / args.reps
            row.update(kernels_per_call=len(iv) / args.reps, busy_us=busy,
                       port_kernels_us=dict(port),
                       idle_share=1 - busy / (row["sync_wall_ms"] * 1e3))
        top = sorted(prof.key_averages(),
                     key=lambda a: -a.self_cpu_time_total)
        row["host_top_us"] = {a.key: a.self_cpu_time_total / args.reps
                              for a in top[:8]}
        print(json.dumps(row), flush=True)
    if args.spmd:
        torch.distributed.destroy_process_group()
    return 0


def bfv_ops(p, fusion: str, msgs) -> tuple[str, dict]:
    """(the schedule, BFVContext's ops by name)."""
    ctx = BFVContext.build(p, fusion=fusion)
    sk, pk = ctx.keygen(nonce=1)
    cts = torch.stack([ctx.encrypt(pk, msgs[j], nonce=j + 1)
                       for j in range(3)])
    m16 = torch.from_numpy(msgs).to(ctx.device)
    rlk = ctx.relin_keygen(sk, nonce=1)
    gk = ctx.galois_keygen(sk, [3], nonce=1)[3]
    ct3 = ctx.mul(cts[0], cts[1])
    td = ctx.tables_drop
    sk_drop = sk[:ctx.params.r - 1].contiguous()
    c0, x = cts[0, 0].contiguous(), ntt_stage.ntt_forward(
        cts[0, 1].contiguous(), td)
    ops = {
        "keygen": lambda: ctx.keygen(nonce=1),
        "encrypt": lambda: ctx.encrypt(pk, m16[0], nonce=1),
        "decrypt": lambda: ctx.decrypt(sk, cts[0]),
        "decrypt_batch_J3": lambda: ctx.decrypt_batch(sk, cts),
        "encrypt_batch_J16": lambda: ctx.encrypt_batch(pk, m16,
                                                       list(range(1, 17))),
        "mul": lambda: ctx.mul(cts[0], cts[1]),
        "mul_relin": lambda: ctx.mul(cts[0], cts[1], rlk=rlk),
        "relin_keygen": lambda: ctx.relin_keygen(sk, nonce=1),
        "relinearize": lambda: ctx.relinearize(ct3, rlk),
        "apply_galois": lambda: ctx.apply_galois(cts[0], 3, gk),
        # decrypt's back half on x = NTT(c1): kernel 15 in one launch, and
        # the two launches BFVContext.decrypt runs (kernel 8 + K2)
        "decrypt_back_15": lambda: bfv_tail.decrypt_fused(
            x, sk_drop, c0, td, ctx.dec_tail_consts),
        "decrypt_back_8_K2": lambda: bfv_tail.decrypt_tail(
            ntt_stage.ntt_inverse_mul(x, sk_drop, td), c0,
            ctx.dec_tail_consts),
    }
    return ctx.fusion, ops


def spmd_ops(p, msgs) -> tuple[str, dict]:
    """("spmd", the ops of SpmdBFVContext, SpmdMultContext and
    Spmd2DBFVContext by name) at world size 1 over NCCL (the default meshes
    and device)."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    multihost.initialize(f"tcp://localhost:{port}", 1, 0)
    ctx = spmd.SpmdBFVContext.build(p)
    sk, pk = ctx.keygen(nonce=1)
    m0 = torch.from_numpy(msgs[0]).to(ctx.device)
    ct = ctx.encrypt(pk, m0, nonce=1)
    ct2 = ctx.encrypt(pk, torch.from_numpy(msgs[1]).to(ctx.device), nonce=2)
    mctx = spmd_mult.SpmdMultContext.build(ctx)
    rlk = mctx.relin_keygen(sk, nonce=1)
    gk = mctx.galois_keygen(sk, [3], nonce=1)[3]
    ct3 = mctx.mul(ct, ct2)
    ctx2 = spmd2d.Spmd2DBFVContext.build(p)
    sk2, pk2 = ctx2.keygen(nonce=1)
    ct_2 = ctx2.encrypt(pk2, m0, nonce=1)
    return "spmd", {
        "keygen": lambda: ctx.keygen(nonce=1),
        "encrypt": lambda: ctx.encrypt(pk, m0, nonce=1),
        "decrypt": lambda: ctx.decrypt(sk, ct),
        "mod_switch": lambda: ctx.mod_switch_to_next(ct),
        "mul": lambda: mctx.mul(ct, ct2),
        "relinearize": lambda: mctx.relinearize(ct3, rlk),
        "apply_galois": lambda: mctx.apply_galois(ct, 3, gk),
        "keygen_2d": lambda: ctx2.keygen(nonce=1),
        "encrypt_2d": lambda: ctx2.encrypt(pk2, m0, nonce=1),
        "decrypt_2d": lambda: ctx2.decrypt(sk2, ct_2),
    }


if __name__ == "__main__":
    sys.exit(main())
