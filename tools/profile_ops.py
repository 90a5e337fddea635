"""Where the time of each BFV op of the PyTorch/CUDA port goes, on one card.

    python3 tools/profile_ops.py [--set 32k_9q] [--fusion auto] [--reps 30]
                                 [--ops keygen,encrypt,...] [--spmd]
                                 [--ntt30] [--kernels] [--root DIR]

For keygen, encrypt, decrypt, decrypt_batch (J = 3), encrypt_batch
(J = 16, nonces 1..16), the EvalMult ops (mul, mul with
relinearization, square, relin_keygen, relinearize), apply_galois (g = 3) and
decrypt's back half on x = NTT(c1) (`decrypt_back_15`: kernel 15;
`decrypt_back_8_K2`: kernel 8 + K2, as `BFVContext.decrypt` runs it) of
one parameter set, through `BFVContext` (`--ops` picks some of them), or
with `--spmd` for keygen, encrypt, decrypt, mod_switch_to_next and the
level-1 decrypt through the RNS-sharded `SpmdBFVContext` and mul,
relinearize, mul with relinearization (`mul_rlk`), apply_galois (g = 3)
and decrypt3 through its `SpmdMultContext`, and keygen, encrypt and
decrypt through the 2-D `Spmd2DBFVContext` and mul with
relinearization and apply_galois (g = 3) through its `Spmd2DMultContext`
(`keygen_2d`, ..., `mul_rlk_2d`, `apply_galois_2d`; mesh (1, 1)), at
world size 1 over NCCL, or with `--ntt30` for kernel 22 alone
(`ntt30_fwd_32768`, ... : forward and inverse at (16, 1, n), n = 2^15 and
2^16, int32, bench.py's shape), or with `--kernels` for the BEHZ
conversions and K2 alone through their wrappers at the set's EvalMult
shapes, J = 1 (`rns_to_bsk` over (2, 2, k, n), `fast_floor`, `bsk_to_q`
and `scale_and_round` over (3, ., n), the band forms at rows [0, r),
`decrypt_tail` at (r-1, n) and (3, r-1, n)), and every launch of the
encrypt tail and kernels 15 and 17 at the main paths' shapes (tail_ops:
K5 at J = 1 and 16, 13, 19, 14, 16 and its drop at rows [0, r) and
[6, r), 17 there at levels 0 and 1), and K1 and kernel 6 at the streams
the draws launch them for (keystream_ops: keygen, encrypt and
relin_keygen's, J = 16), prints one JSON line per op:

* `event_ms`: median CUDA-event time around one call;
* `sync_wall_ms`: median host time of one call ending in
  `torch.cuda.synchronize()` (no profiler running);
* under `torch.profiler` over `--reps` calls: `kernels_per_call` (CUDA
  kernels and copies), `busy_us` (the union of their device intervals, per
  call), `port_kernels_us` (the csrc kernels, `k_*`, by name, per call;
  fused_ops.cu's kernels carry the op's struct as a template argument),
  `idle_share` = 1 - busy / sync wall, `host_top_us`: the eight host
  events (PyTorch ops and CUDA runtime calls) with the most self time,
  per call, and `glue_top_us`: the ten host events with the most self
  device time (the kernels each launched itself: an aten op's are the
  plain glue, a `cuLaunchKernel`'s the csrc kernels), keyed by name and
  input shapes, per call.

`--spmd` also times `mod_u64_digits_2d`: the 2-D key switch's digit
reduction alone (`modmath.mod_u64` of the (r-1, 1, n) gathered rows into
the r moduli, as `Spmd2DMultContext._keyswitch` runs it at mesh (1, 1)).

`--root DIR` imports the package from another checkout (e.g. the parent
commit's, unpacked with `git archive` into a git-ignored directory), so
that two trees are timed by the same script on the same card, in turns.

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

ROOT = (Path(sys.argv[sys.argv.index("--root") + 1]).resolve()
        if "--root" in sys.argv else Path(__file__).resolve().parents[1])
sys.path.insert(0, str(ROOT))

from ntt_cuda_tpu_torch import BFVContext, get_bfv_params  # noqa: E402
from ntt_cuda_tpu_torch.ops import (behz, behz_kernels,  # noqa: E402
                                    bfv_tail, fused_ops, modmath, ntt,
                                    ntt30, ntt_stage, salsa20, sampling)
from ntt_cuda_tpu_torch.params import get_params  # noqa: E402
from ntt_cuda_tpu_torch.parallel import (multihost, spmd,  # noqa: E402
                                         spmd2d, spmd2d_mult, spmd_mult)


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
    ap.add_argument("--ntt30", action="store_true",
                    help="kernel 22 at (16, 1, n), n = 2^15 and 2^16")
    ap.add_argument("--kernels", action="store_true",
                    help="the BEHZ conversions, K2, the encrypt tail's "
                         "launches and kernels 15 and 17 at --set")
    ap.add_argument("--root", default=str(ROOT),
                    help="the checkout whose package is timed")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("profile_ops.py needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    p = get_bfv_params(args.set)
    msgs = np.random.default_rng(1).integers(0, p.t, (16, p.n))
    if args.ntt30:
        fusion, ops = "ntt30", ntt30_ops()
    elif args.kernels:
        fusion, ops = "kernels", kernel_ops(p)
    else:
        fusion, ops = (spmd_ops(p, msgs) if args.spmd
                       else bfv_ops(p, args.fusion, msgs))
    if args.ops:
        ops = {k: ops[k] for k in args.ops.split(",")}
    for name, fn in ops.items():
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        row = {"root": args.root, "set": args.set, "fusion": fusion,
               "op": name,
               "event_ms": event_ms(fn, args.reps),
               "sync_wall_ms": wall_ms(fn, args.reps)}
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
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
        row["glue_top_us"] = glue_top_us(prof, args.reps)
        print(json.dumps(row), flush=True)
    if args.spmd:
        torch.distributed.destroy_process_group()
    return 0


def glue_top_us(prof, reps: int, top: int = 10) -> dict:
    """{"name shapes": self device µs a call} of the `top` host events
    whose own launches take the most device time."""
    def dev_us(a):
        return getattr(a, "self_device_time_total",
                       getattr(a, "self_cuda_time_total", 0.0))
    host = [a for a in prof.key_averages(group_by_input_shape=True)
            if a.device_type == torch.autograd.DeviceType.CPU
            and dev_us(a) > 0]
    host.sort(key=lambda a: -dev_us(a))
    return {f"{a.key} {a.input_shapes}": dev_us(a) / reps for a in host[:top]}


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
        "square": lambda: ctx.square(cts[0]),
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


def ntt30_ops() -> dict:
    """Kernel 22's forward and inverse at (16, 1, n), int32, by name."""
    ops = {}
    for n in (32768, 65536):
        q, psi, *_ = get_params(n, "30bit")
        tb = ntt30.NTTTables30.build([q], [psi], n)
        x = torch.from_numpy(np.random.default_rng(1).integers(
            0, q, (16, 1, n)).astype(np.int32)).to(tb.device)
        f = ntt30.ntt_forward(x, tb)
        ops[f"ntt30_fwd_{n}"] = lambda x=x, tb=tb: ntt30.ntt_forward(x, tb)
        ops[f"ntt30_inv_{n}"] = lambda f=f, tb=tb: ntt30.ntt_inverse(f, tb)
    return ops


def kernel_ops(p) -> dict:
    """The BEHZ conversions (21a-c, scale_and_round, the bands at rows
    [0, r)) and K2 by name, through their wrappers, on seeded residues at
    the EvalMult path's shapes (J = 1); then the launches of the encrypt
    tail and kernels 15 and 17 (tail_ops)."""
    dev = torch.device("cuda", torch.cuda.current_device())
    n, k = p.n, p.r - 1
    rng = np.random.default_rng(2)

    def res(qs, lead):
        return torch.from_numpy(np.stack(
            [rng.integers(0, q, lead + (n,)) for q in qs], axis=-2)).to(dev)
    aux = behz.AuxBase.build(p)
    mc = behz_kernels.SpmdMultConsts.build(p, aux, dev)
    mb, dt = mc.banks, bfv_tail.DecTailConsts.build(p, dev)
    bk, r = behz_kernels, p.r
    xa, xq, xb = res(p.q[:k], (2, 2)), res(p.q[:k], (3,)), res(aux.bsk, (3,))
    x1, c1 = res(p.q[:k], ()), res(p.q[:k], ())
    x3, c3 = res(p.q[:k], (3,)), res(p.q[:k], (3,))
    return {
        "rns_to_bsk": lambda: bk.rns_to_bsk(xa, mb),
        "fast_floor": lambda: bk.fast_floor(xq, xb, mb),
        "bsk_to_q": lambda: bk.bsk_to_q(xb, mb),
        "scale_and_round": lambda: bk.scale_and_round(xq, xb, mb),
        "rns_to_bsk_rows": lambda: bk.rns_to_bsk_rows(xa, mc, 0, r),
        "fast_floor_rows": lambda: bk.fast_floor_rows(xq, xb, mc, 0, r),
        "bsk_to_q_rows": lambda: bk.bsk_to_q_rows(xb, mc, 0, r),
        "decrypt_tail": lambda: bfv_tail.decrypt_tail(x1, c1, dt),
        "decrypt_tail_J3": lambda: bfv_tail.decrypt_tail(x3, c3, dt),
        **tail_ops(p, dev, res, mc),
        **keystream_ops(p, dev),
    }


def keystream_ops(p, dev) -> dict:
    """K1 at keygen's, encrypt's and relin_keygen's streams (k = r - 1
    keys) and kernel 6 at encrypt's for J = 16 nonces, as the draws launch
    them: through keystream_words(_batch), or, in a checkout from before
    those (`--root`), through keystream_block_words(_batch) with the u64
    lanes where its draws took them."""
    n, r = p.n, p.r
    streams = {"keygen": (sampling.keygen_entropy_bytes(n, r), 0x01, True),
               "encrypt": (sampling.encrypt_entropy_bytes(n), 0x01, False),
               "relin_keygen": (sampling.relin_entropy_bytes(n, r, r - 1),
                                0x02, True)}
    flat = hasattr(salsa20, "keystream_words")
    ops = {}
    for name, (nbytes, key, lanes) in streams.items():
        kw = dict(key_byte=key, nonce=1, device=dev)
        if not flat:
            kw["with_u64"] = lanes
        ops[f"salsa20_K1_{name}"] = (
            lambda nb=-(-nbytes // 64), kw=kw: (
                salsa20.keystream_words if flat
                else salsa20.keystream_block_words)(nb, **kw))
    nb = -(-sampling.encrypt_entropy_bytes(n) // 64)
    ns = sampling.encrypt_nonces(range(1, 17))
    batch = (salsa20.keystream_words_batch if flat
             else salsa20.keystream_block_words_batch)
    ops["salsa20_6_J16"] = lambda: batch(nb, ns, device=dev)
    return ops


def tail_ops(p, dev, res, mc) -> dict:
    """Every launch of the encrypt tail and kernels 15 and 17 by name,
    through their wrappers at the main paths' shapes: K5 (encrypt_fused,
    the op transform then the tail) at J = 1 and 16, 13 (the stage
    encrypt's inverse then the tail), 19 (keyswitch_fused: two transform
    launches then the tail as the modulus drop), 14, 16 and its drop at
    rows [0, r) and [6, r) (the world-size-1 and the R = 3 last rank's
    rows), 17 there at levels 0 and 1, and 15; port_kernels_us splits the
    tail's time from the transforms' by kernel name."""
    n, r, k = p.n, p.r, p.r - 1
    rng = np.random.default_rng(3)
    ctx = BFVContext.build(p, device=dev, fusion="op")
    tf, tc = ctx.tables_full, ctx.tail_consts
    _, pk = ctx.keygen(nonce=1)
    u16, e16 = sampling.encrypt_draws_compact_batch(n, range(1, 17),
                                                    device=dev)
    m16 = torch.from_numpy(rng.integers(0, p.t, (16, n))).to(dev)
    u_ntt = ntt.ntt_forward(sampling.small_res(u16[0], tf.ms.q), tf)
    c2, ksk = res(p.q[:k], ()), res(p.q, (2, k))
    c, e = res(p.q, (2,)), res(p.q, (2,))
    td = ctx.tables_drop
    xs, sk, c0 = res(p.q[:k], ()), res(p.q[:k], ()), res(p.q[:k], ())
    ops = {
        "encrypt_fused_K5_J1": lambda: fused_ops.encrypt_fused(
            u16[0], pk, e16[0], m16[0], tf, tc),
        "encrypt_fused_K5_J16": lambda: fused_ops.encrypt_fused(
            u16, pk, e16, m16, tf, tc),
        "encrypt_fused_13": lambda: bfv_tail.encrypt_fused(
            u_ntt, pk, e16[0], m16[0], tf, tc),
        "keyswitch_fused_19": lambda: fused_ops.keyswitch_fused(c2, ksk, tf,
                                                                tc),
        "encrypt_tail_14": lambda: bfv_tail.encrypt_tail(c, e, m16[0], tc),
        "decrypt_fused_15": lambda: bfv_tail.decrypt_fused(
            xs, sk, c0, td, ctx.dec_tail_consts),
    }
    for lo in [lo for lo in (0, 6) if lo < r]:
        rows = f"rows{lo}-{r}"
        pt = bfv_tail.build_tail_consts_padded(p, lo, r, dev)
        dc = spmd_mult.drop_consts(mc, p.q[-1], lo, r)
        cl, el = res(p.q[lo:], (2,)), res(p.q[lo:], (2,))
        ra = res(p.q[-1:] * 2, ())
        ops[f"encrypt_tail_padded_16_{rows}"] = (
            lambda cl=cl, el=el, ra=ra, pt=pt: bfv_tail.encrypt_tail_padded(
                cl, el, ra, m16[0], pt))
        ops[f"drop_last_padded_{rows}"] = (
            lambda cl=cl, ra=ra, dc=dc: bfv_tail.drop_last_padded(cl, ra, dc))
        x, x0 = res(p.q[lo:], ()), res(p.q[lo:], ())
        for level in (0, 1):
            cp = spmd._chain_params(p, level)
            pc = bfv_tail.build_dec_tail_consts_padded(
                cp, lo, min(r, cp.r), pad_to=r, device=dev)
            ops[f"decrypt_tail_partial_17_{rows}_L{level}"] = (
                lambda x=x, x0=x0, pc=pc: bfv_tail.decrypt_tail_partial(
                    x, x0, pc))
    return ops


def spmd_ops(p, msgs) -> tuple[str, dict]:
    """("spmd", the ops of SpmdBFVContext, SpmdMultContext,
    Spmd2DBFVContext and Spmd2DMultContext by name) at world size 1 over
    NCCL (the default meshes and device)."""
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
    ct_sw = ctx.mod_switch_to_next(ct)
    ctx2 = spmd2d.Spmd2DBFVContext.build(p)
    sk2, pk2 = ctx2.keygen(nonce=1)
    ct_2 = ctx2.encrypt(pk2, m0, nonce=1)
    ct2_2 = ctx2.encrypt(pk2, torch.from_numpy(msgs[1]).to(ctx.device),
                         nonce=2)
    mctx2 = spmd2d_mult.Spmd2DMultContext.build(ctx2)
    rlk2 = mctx2.relin_keygen(sk2, nonce=1)
    gk2 = mctx2.galois_keygen(sk2, [3], nonce=1)[3]
    digits = ct_2.to_local()[1, :p.r - 1, None, :].contiguous()
    return "spmd", {
        "keygen": lambda: ctx.keygen(nonce=1),
        "encrypt": lambda: ctx.encrypt(pk, m0, nonce=1),
        "decrypt": lambda: ctx.decrypt(sk, ct),
        "mod_switch": lambda: ctx.mod_switch_to_next(ct),
        "decrypt_L1": lambda: ctx.decrypt(sk, ct_sw, level=1),
        "decrypt3": lambda: mctx.decrypt3(sk, ct3),
        "mul": lambda: mctx.mul(ct, ct2),
        "relinearize": lambda: mctx.relinearize(ct3, rlk),
        "mul_rlk": lambda: mctx.mul(ct, ct2, rlk=rlk),
        "apply_galois": lambda: mctx.apply_galois(ct, 3, gk),
        "keygen_2d": lambda: ctx2.keygen(nonce=1),
        "encrypt_2d": lambda: ctx2.encrypt(pk2, m0, nonce=1),
        "decrypt_2d": lambda: ctx2.decrypt(sk2, ct_2),
        "mul_rlk_2d": lambda: mctx2.mul(ct_2, ct2_2, rlk=rlk2),
        "apply_galois_2d": lambda: mctx2.apply_galois(ct_2, 3, gk2),
        "mod_u64_digits_2d": lambda: modmath.mod_u64(digits, ctx2.ms.q,
                                                     ctx2.ms.nu),
    }


if __name__ == "__main__":
    sys.exit(main())
