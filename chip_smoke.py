"""Smoke run of the PyTorch/CUDA port (ntt_cuda_tpu_torch) on one card.

    python3 chip_smoke.py

Builds the CUDA kernels from ntt_cuda_tpu_torch/csrc with nvcc (sm_90a),
holds each kernel exactly (tolerance 0) against its plain PyTorch version
on the card at the 4k_3q and 16k_5q shapes, decrypts the reference's
golden ciphertext, then drives the BFV main path at 16k_5q through the
public API (keygen, encrypt of three seeded messages, decrypt,
decrypt_batch), checks it against the messages and against the same path
run in plain PyTorch on the CPU, checks that every kernel launched during
that run, and times the ops and the kernels with CUDA events.

Prints the card's name and power limit, one JSON line of per-kernel
results, and last `{"ok": true, "device": {...}}`.  Any failure raises,
so the exit code is not 0 and no result line is printed.  Imports no jax.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from ntt_cuda_tpu_torch import BFVContext, cuda, get_bfv_params  # noqa: E402
from ntt_cuda_tpu_torch.ops import (bfv_tail, fused_ops, salsa20,  # noqa: E402
                                    sampling)

SEED = 20261016
MAIN_SET = "16k_5q"
CHECK_SETS = ("4k_3q", "16k_5q")

# name -> (wrapper, CUDA source, the TPU kernel it replaces)
KERNELS = {
    "salsa20_keystream": (salsa20.keystream_block_words,
                          "ntt_cuda_tpu_torch/csrc/salsa20.cu",
                          "ntt_cuda_tpu/ops/salsa20.py:174"),
    "decrypt_tail": (bfv_tail.decrypt_tail,
                     "ntt_cuda_tpu_torch/csrc/decrypt_tail.cu",
                     "ntt_cuda_tpu/ops/bfv_tail.py:388"),
    "half_polymul": (fused_ops.half_polymul,
                     "ntt_cuda_tpu_torch/csrc/fused_ops.cu",
                     "ntt_cuda_tpu/ops/fused_ops.py:213"),
    "keygen_fused": (fused_ops.keygen_fused,
                     "ntt_cuda_tpu_torch/csrc/fused_ops.cu",
                     "ntt_cuda_tpu/ops/fused_ops.py:137"),
    "encrypt_fused": (fused_ops.encrypt_fused,
                      "ntt_cuda_tpu_torch/csrc/fused_ops.cu",
                      "ntt_cuda_tpu/ops/fused_ops.py:466"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def as_list(x):
    return list(x) if isinstance(x, (tuple, list)) else [x]


def compare(name: str, got, ref, errs: dict) -> None:
    """Exact equality of a kernel's outputs with its plain version's."""
    for g, r in zip(as_list(got), as_list(ref)):
        if g.shape != r.shape or g.dtype != r.dtype:
            raise AssertionError(f"{name}: {g.shape}/{g.dtype} vs "
                                 f"{r.shape}/{r.dtype}")
        err = 0.0 if torch.equal(g, r) else float(
            (g.double() - r.double()).abs().max())
        errs[name] = max(errs.get(name, 0.0), err)
        if err != 0.0 or not torch.equal(g, r):
            raise AssertionError(f"{name}: kernel != plain version "
                                 f"(max abs err {err})")


def median_ms(fn, reps: int = 15, warmup: int = 3) -> float:
    """Median device time of one call, from CUDA events around it."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def rand_res(rng, qs, n, lead, device):
    return torch.from_numpy(np.stack(
        [rng.integers(0, q, lead + (n,), dtype=np.int64) for q in qs],
        axis=-2)).to(device)


def kernel_cases(ctx: BFVContext, rng, dev):
    """(kernel name, J, wrapper call, plain call) at the shapes the main
    path gives each kernel, J = 1 and 3 where a batch dim exists."""
    p = ctx.params
    cases = []
    kg_blocks = (sampling.keygen_entropy_bytes(p.n, p.r) + 63) // 64
    enc_blocks = (sampling.encrypt_entropy_bytes(p.n) + 63) // 64
    for nb, with_u64 in ((kg_blocks, True), (enc_blocks, False)):
        kw = dict(nonce=3, with_u64=with_u64, device=dev)
        cases.append(("salsa20_keystream", nb,
                      lambda nb=nb, kw=kw: salsa20.keystream_block_words(nb, **kw),
                      lambda nb=nb, kw=kw: salsa20.keystream_plain(nb, **kw)))
    s_b, a, e_d = sampling.keygen_draws_compact(p.n, p.r, ctx.tables_full.ms,
                                                nonce=1)
    tf, td = ctx.tables_full, ctx.tables_drop
    cases.append(("keygen_fused", 1,
                  lambda: fused_ops.keygen_fused(s_b, a, e_d, tf),
                  lambda: fused_ops.keygen_fused_plain(s_b, a, e_d, tf)))
    sk, pk0 = fused_ops.keygen_fused(s_b, a, e_d, tf)
    pk = torch.stack([pk0, a])
    sk_drop = sk[: p.r - 1].contiguous()
    for J in (1, 3):
        lead = () if J == 1 else (J,)
        x = rand_res(rng, p.q[:-1], p.n, lead, dev)
        c0 = rand_res(rng, p.q[:-1], p.n, lead, dev)
        dt = ctx.dec_tail_consts
        cases.append(("half_polymul", J,
                      lambda x=x: fused_ops.half_polymul(x, sk_drop, td),
                      lambda x=x: fused_ops.half_polymul_plain(x, sk_drop, td)))
        cases.append(("decrypt_tail", J,
                      lambda x=x, c0=c0: bfv_tail.decrypt_tail(x, c0, dt),
                      lambda x=x, c0=c0: bfv_tail.decrypt_tail_plain(x, c0, dt)))
        draws = [sampling.encrypt_draws_compact(p.n, nonce=k + 1, device=dev)
                 for k in range(J)]
        u_b = torch.stack([d[0] for d in draws])
        e2 = torch.stack([d[1] for d in draws])
        m = torch.from_numpy(rng.integers(0, p.t, (J, p.n))).to(dev)
        if J == 1:
            u_b, e2, m = u_b[0], e2[0], m[0]
        tc = ctx.tail_consts
        cases.append(("encrypt_fused", J,
                      lambda u=u_b, e=e2, m=m: fused_ops.encrypt_fused(
                          u, pk, e, m, tf, tc),
                      lambda u=u_b, e=e2, m=m: fused_ops.encrypt_fused_plain(
                          u, pk, e, m, tf, tc)))
    return cases


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA card; "
                           "torch.cuda.is_available() is False")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    log(smi.stdout.strip())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    cuda.library()
    log(f"build: kernels built and loaded in {time.perf_counter() - t0:.1f} s")

    # Phase 3: every kernel == its plain version, on the card.
    rng = np.random.default_rng(SEED)
    errs: dict[str, float] = {}
    timing_cases = {}
    for name in CHECK_SETS:
        ctx = BFVContext.build(get_bfv_params(name), device=dev)
        for kname, J, kern, plain in kernel_cases(ctx, rng, dev):
            compare(kname, kern(), plain(), errs)
            log(f"check {name} {kname} J/blocks={J}: equal")
            if name == MAIN_SET and kname not in timing_cases:
                timing_cases[kname] = (kern, plain)
    torch.cuda.synchronize()

    # Phase 4: the reference's golden ciphertext.
    ctx4 = BFVContext.build(get_bfv_params("4k_3q"), device=dev)
    fix = ROOT / "tests" / "fixtures"
    ct = np.stack([np.load(fix / "dec4k_c0.npy"), np.load(fix / "dec4k_c1.npy")])
    m = ctx4.decrypt(np.load(fix / "dec4k_sk_ntt.npy"), ct).cpu().numpy()
    if not np.array_equal(m, np.arange(ctx4.params.n) % 10):
        raise AssertionError("golden dec4k ciphertext does not decrypt to i % 10")
    log("golden: dec4k decrypts to i % 10 on the card")

    # Phase 5: the main path at 16k_5q, through the public API.
    p = get_bfv_params(MAIN_SET)
    ctx = BFVContext.build(p, device=dev)
    msgs = np.random.default_rng(SEED).integers(0, p.t, (3, p.n))
    for wrapper, _, _ in KERNELS.values():
        wrapper.launches = 0
    sk, pk = ctx.keygen(nonce=1)
    cts = [ctx.encrypt(pk, msgs[j], nonce=j + 1) for j in range(3)]
    outs = [ctx.decrypt(sk, c) for c in cts]
    outb = ctx.decrypt_batch(sk, torch.stack(cts))
    torch.cuda.synchronize()
    launches = {k: w.launches for k, (w, _, _) in KERNELS.items()}
    for j in range(3):
        if not np.array_equal(outs[j].cpu().numpy(), msgs[j]):
            raise AssertionError(f"{MAIN_SET}: decrypt(encrypt(m{j})) != m{j}")
    if not np.array_equal(outb.cpu().numpy(), msgs):
        raise AssertionError(f"{MAIN_SET}: decrypt_batch != messages")
    log(f"main path {MAIN_SET}: 3 messages round-trip; decrypt_batch agrees")
    cpu = BFVContext.build(p, device="cpu")
    sk_c, pk_c = cpu.keygen(nonce=1)
    cts_c = [cpu.encrypt(pk_c, msgs[j], nonce=j + 1) for j in range(3)]
    if not (torch.equal(sk.cpu(), sk_c) and torch.equal(pk.cpu(), pk_c)
            and all(torch.equal(a.cpu(), b) for a, b in zip(cts, cts_c))):
        raise AssertionError("card keys/ciphertexts != CPU plain path")
    log("main path: keys and ciphertexts equal the CPU plain path bit for bit")
    log(f"launch counts in the main-path run: {launches}")
    missing = [k for k, v in launches.items() if v < 1]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")

    # Phase 7: times on the card, 16k_5q main-path shapes.
    m0 = torch.from_numpy(msgs[0]).to(dev)
    op_ms = {
        "keygen": median_ms(lambda: ctx.keygen(nonce=1)),
        "encrypt": median_ms(lambda: ctx.encrypt(pk, m0, nonce=1)),
        "decrypt": median_ms(lambda: ctx.decrypt(sk, cts[0])),
        "decrypt_batch_J3": median_ms(
            lambda: ctx.decrypt_batch(sk, torch.stack(cts))),
    }
    log(f"op times {MAIN_SET} (ms, median of CUDA-event timings): "
        f"{json.dumps(op_ms)}")
    rows = []
    for kname, (wrapper, source, replaces) in KERNELS.items():
        kern, plain = timing_cases[kname]
        rows.append({"name": kname, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[kname],
                     "max_abs_err": errs[kname],
                     "ms": median_ms(kern), "plain_ms": median_ms(plain)})
    torch.cuda.synchronize()
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
