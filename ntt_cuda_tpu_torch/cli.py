"""The command line: the analogues of the reference's four main() files.

    python -m ntt_cuda_tpu_torch demo            # demo.cu: keygen->enc->dec + timing
    python -m ntt_cuda_tpu_torch ntt-test        # 60bit_ntt_test.cu: polymul vs golden
    python -m ntt_cuda_tpu_torch decryption-test # decryption_test.cu: golden vectors
    python -m ntt_cuda_tpu_torch keygen-test     # keygen_test.cu: ternary histogram
    python -m ntt_cuda_tpu_torch keys / encrypt / decrypt   # .npz flows

The port's counterpart of `ntt_cuda_tpu/cli.py`: the same subcommands,
flags and PASS/FAIL lines.  The JAX `--backend` flag becomes `--device`
(the CUDA card by default, raising where there is none; `cpu` runs every
kernel's plain version) and `--fusion auto|op|stage`.  `demo --time`
prints the JAX CLI's per-phase lines: the slope between two lengths of a
chain of data-dependent ops (`BFVContext.op_programs`), each chain a CUDA
graph timed by CUDA events (utils/profiling.py time_chained; eager under
the host clock with `--device cpu`), and beside them the median time of
one eager call.  The .npz files interchange with the JAX CLI's.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import cuda


def _device(args, name: str) -> torch.device:
    return cuda.default_device(args.device or None, name)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _ctx(args):
    from .models.bfv import BFVContext
    from .params import get_bfv_params
    params = get_bfv_params(args.params)
    return params, BFVContext.build(params, device=_device(args, args.cmd),
                                    fusion=args.fusion)


def phase_chains(ctx, sk, pk, m):
    """(kg_make, enc_make, dec_make): make(k) returns the function of a
    carry that chains k data-dependent steps of an op program
    (BFVContext.op_programs), the JAX CLI's chains (its cli.py:56-82), so
    that no step is the same call twice: keygen carries sk[0, 0] +
    pk[0, 0, 0] + pk[1, 0, 0] (both outputs used; int64 sums wrap as the
    u64 ones do) into the next nonce, encrypt of m under pk takes its
    nonce from ct[0, 0, 0], decrypt under sk adds out[0] to ct[0, 0, 0]
    mod q0."""
    kg_fn, enc_fn, dec_fn, _, _, bz = ctx.op_programs()
    q0 = ctx.params.q[0]

    def kg_make(k):
        def step(seed):
            for _ in range(k):
                skk, pkk = kg_fn(seed, bz)
                seed = skk[0, 0] + pkk[0, 0, 0] + pkk[1, 0, 0]
            return seed
        return step

    def enc_make(k):
        def step(c):
            for _ in range(k):
                c = enc_fn(c[0, 0, 0], pk, m, bz)
            return c
        return step

    def dec_make(k):
        def step(c):
            for _ in range(k):
                out = dec_fn(sk, c, bz)
                c = c.clone()
                c[0, 0, 0] = (c[0, 0, 0] + out[0]) % q0
            return c
        return step

    return kg_make, enc_make, dec_make


def _phase_times(ctx, params, inner=None):
    """Per-phase latency in seconds: keygen, encrypt, decrypt (the JAX
    CLI's _phase_times): the slope between two lengths of each phase's
    chain (phase_chains) from keygen(), m = arange(n) mod t and its
    ciphertext.  The chain lengths are JAX's, hi = max(64, 2^24 // (n r))
    and lo = hi // 8, or `inner` = (lo, hi)."""
    from .utils import profiling

    dev = ctx.device
    m = torch.arange(params.n, dtype=torch.int64, device=dev) % params.t
    sk, pk = ctx.keygen()
    ct = ctx.encrypt(pk, m)
    if inner is None:
        hi = max(64, (1 << 24) // (params.n * params.r))
        lo = hi // 8
    else:
        lo, hi = inner
    kg_make, enc_make, dec_make = phase_chains(ctx, sk, pk, m)
    seed = torch.ones((), dtype=torch.int64, device=dev)
    t_kg = profiling.time_chained(kg_make, seed, lo, hi)
    t_enc = profiling.time_chained(enc_make, ct, lo, hi)
    t_dec = profiling.time_chained(dec_make, ct, lo, hi)
    return t_kg, t_enc, t_dec


def cmd_demo(args) -> int:
    """demo.cu: keygen -> encrypt -> decrypt, verify, time."""
    from .utils import golden, profiling

    params, ctx = _ctx(args)
    dev = ctx.device
    print(f"[demo] device={dev} fusion={ctx.fusion} n={params.n} "
          f"r={params.r} t={params.t}")
    rng = np.random.default_rng(args.seed)
    m = torch.from_numpy(rng.integers(0, params.t, params.n,
                                      dtype=np.uint64).astype(np.int64))
    m = m.to(dev)

    t0 = time.perf_counter()
    sk, pk = ctx.keygen()
    ct = ctx.encrypt(pk, m)
    out = ctx.decrypt(sk, ct)
    _sync(dev)
    t_first = time.perf_counter() - t0
    ok = torch.equal(out, m)
    print(f"[demo] decrypt(encrypt(m)) == m: {'PASS' if ok else 'FAIL'} "
          f"(first run incl. kernel build: {t_first:.1f}s)")
    if not ok:
        return 1
    if args.time:
        t_kg, t_enc, t_dec = _phase_times(ctx, params)
        print(f"[demo] keygen  {t_kg*1e6:9.1f} us")
        print(f"[demo] encrypt {t_enc*1e6:9.1f} us")
        print(f"[demo] decrypt {t_dec*1e6:9.1f} us")
        eager = [profiling.median_ms(fn, device=dev) * 1e3
                 for fn in (lambda: ctx.keygen(), lambda: ctx.encrypt(pk, m),
                            lambda: ctx.decrypt(sk, ct))]
        print(f"[demo] one eager call (median): keygen {eager[0]:.1f} us, "
              f"encrypt {eager[1]:.1f} us, decrypt {eager[2]:.1f} us")
    if args.mul:
        m2 = torch.from_numpy(rng.integers(0, params.t, params.n,
                                           dtype=np.uint64).astype(np.int64))
        m2 = m2.to(dev)
        ct2 = ctx.encrypt(pk, m2, nonce=1)
        t0 = time.perf_counter()
        rlk = ctx.relin_keygen(sk)
        prod = ctx.mul(ct, ct2, rlk=rlk)
        outp = ctx.decrypt(sk, prod)
        _sync(dev)
        t_first = time.perf_counter() - t0
        exp = golden.schoolbook_negacyclic(m, m2, params.t, params.n)
        okm = torch.equal(outp, exp)
        print(f"[demo] decrypt(mul(ct, ct2)) == m*m2: "
              f"{'PASS' if okm else 'FAIL'} "
              f"(first run incl. kernel build: {t_first:.1f}s)")
        if not okm:
            return 1
        if args.time:
            us = profiling.median_ms(lambda: ctx.mul(ct, ct2, rlk=rlk),
                                     device=dev) * 1e3
            print(f"[demo] mul+relin {us:9.1f} us")
    return 0


def ntt_tables(q: int, psi: int, n: int, family: str, device):
    """The transform tables of ntt-test's modulus: NTTTables30 for the
    30-bit family, NTTTables for the 60-bit one."""
    from .ops import ntt, ntt30
    cls = ntt30.NTTTables30 if family == "30bit" else ntt.NTTTables
    return cls.build([q], [psi], n, device)


def ntt_polymul(x: torch.Tensor, tables, q: int, family: str) -> torch.Tensor:
    """ntt-test's product of the stacked pair x (2, 1, n) int64, (n,)
    int64.  60bit: kernel 7 forward over the pair, then kernel 8
    (INTT(x (.) y)); 30bit: kernel 22 forward over the pair (int32), the
    dyadic product mod q (exact in int64, q < 2^30), kernel 22 inverse."""
    from .ops import ntt30, ntt_stage
    if family == "30bit":
        f = ntt30.ntt_forward(x.to(torch.int32), tables).to(torch.int64)
        prod = ((f[0] * f[1]) % q).to(torch.int32)
        return ntt30.ntt_inverse(prod, tables)[0].to(torch.int64)
    f = ntt_stage.ntt_forward(x, tables)
    return ntt_stage.ntt_inverse_mul(f[0], f[1], tables)[0]


def cmd_ntt_test(args) -> int:
    """60bit_ntt_test.cu (old/30bit_ntt_test.cu for --family 30bit): NTT ->
    dyadic -> INTT (ntt_polymul) against the schoolbook product."""
    from .params import get_params
    from .utils import golden

    dev = _device(args, "ntt-test")
    n = args.n
    q, psi, _, _, _ = get_params(n, family=args.family)
    print(f"[ntt-test] n={n} q={q} ({q.bit_length()} bits, "
          f"{args.family} family) device={dev}")
    rng = np.random.default_rng(args.seed)
    a = rng.integers(0, q, n, dtype=np.uint64).astype(np.int64)
    b = rng.integers(0, q, n, dtype=np.uint64).astype(np.int64)
    x = torch.from_numpy(np.stack([a, b])[:, None, :]).to(dev)  # (2, 1, n)
    got = ntt_polymul(x, ntt_tables(q, psi, n, args.family, dev), q,
                      args.family)
    ok = torch.equal(got, golden.schoolbook_negacyclic(x[0, 0], x[1, 0], q, n))
    print(f"[ntt-test] polymul vs schoolbook golden model: "
          f"{'PASS' if ok else 'FAIL'}")
    return 0 if ok else 1


def cmd_decryption_test(args) -> int:
    """decryption_test.cu: the reference's golden-vector decryption."""
    from .models.bfv import BFVContext
    from .params import get_bfv_params

    fix = Path(args.fixtures)
    params = get_bfv_params("4k_3q")
    ctx = BFVContext.build(params, device=_device(args, "decryption-test"),
                           fusion=args.fusion)
    ct = np.stack([np.load(fix / "dec4k_c0.npy"), np.load(fix / "dec4k_c1.npy")])
    sk = np.load(fix / "dec4k_sk_ntt.npy")
    t0 = time.perf_counter()
    out = ctx.decrypt(sk, ct).cpu().numpy()
    dt = time.perf_counter() - t0
    ok = np.array_equal(out, np.arange(params.n) % 10)
    print(f"[decryption-test] reference golden vectors (n=4096, r=3): "
          f"{'PASS' if ok else 'FAIL'} ({dt:.2f}s incl. kernel build)")
    return 0 if ok else 1


def cmd_keygen_test(args) -> int:
    """keygen_test.cu: the ternary sampler's histogram (the reference draws
    341M samples and eyeballs the -1/0/1 balance; this draws fewer and
    asserts a 4-sigma band)."""
    from .ops import salsa20

    dev = _device(args, "keygen-test")
    nbytes = args.samples
    ks = salsa20.bytes_u8(salsa20.keystream_for_bytes(nbytes, device=dev), 0,
                          nbytes)
    # convert_ternary as the sampler ships it (bfv_keygen.cuh:29-30):
    # byte // 85 - 1 in {-1, 0, 1, 2}; byte 255 gives 2, the reference's
    # quirk, not a clamped 1
    counts = torch.bincount(torch.div(ks, 85, rounding_mode="floor"),
                            minlength=4).tolist()
    hist = {v: int(counts[v + 1]) for v in (-1, 0, 1, 2)}
    total = sum(hist.values())
    print(f"[keygen-test] {total} ternary samples: {hist}")
    # bytes 0..84 -> -1, 85..169 -> 0, 170..254 -> 1, 255 -> 2
    p = {-1: 85 / 256, 0: 85 / 256, 1: 85 / 256, 2: 1 / 256}
    ok = True
    for v, cnt in hist.items():
        mu = total * p[v]
        sigma = (total * p[v] * (1 - p[v])) ** 0.5
        dev_sigma = abs(cnt - mu) / sigma
        print(f"[keygen-test]   {v:+d}: {cnt} (expected {mu:.0f}, "
              f"{dev_sigma:.2f} sigma)")
        ok = ok and dev_sigma < 4.0
    print(f"[keygen-test] {'PASS' if ok else 'FAIL'}")
    return 0 if ok else 1


def cmd_keys(args) -> int:
    """Generate a keypair and save it (.npz)."""
    from .utils import serialize
    params, ctx = _ctx(args)
    sk, pk = ctx.keygen()
    serialize.save_keypair(args.out, params, sk, pk)
    print(f"[keys] wrote keypair for {params.name} -> {args.out}")
    return 0


def cmd_encrypt(args) -> int:
    from .utils import serialize
    params, ctx = _ctx(args)
    _, pk = serialize.load_keypair(args.keys, params)
    rng = np.random.default_rng(args.seed)
    m = (np.arange(params.n, dtype=np.uint64) % params.t
         if args.message == "ramp"
         else rng.integers(0, params.t, params.n, dtype=np.uint64))
    ct = ctx.encrypt(pk, m)
    serialize.save_ciphertext(args.out, params, ct)
    print(f"[encrypt] wrote ciphertext ({args.message}) -> {args.out}")
    return 0


def cmd_decrypt(args) -> int:
    from .utils import serialize
    params, ctx = _ctx(args)
    sk, _ = serialize.load_keypair(args.keys, params)
    ct = serialize.load_ciphertext(args.ct, params)
    out = ctx.decrypt(sk, ct).cpu().numpy()
    print(f"[decrypt] plaintext head: {out[:16].tolist()}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ntt_cuda_tpu_torch",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--params", default="4k_3q",
                    help="parameter set name (default 4k_3q)")
    ap.add_argument("--device", default="",
                    help="torch device (default: the CUDA card, an error "
                         "where there is none; cpu runs the plain versions)")
    ap.add_argument("--fusion", default="auto", choices=["auto", "op", "stage"],
                    help="kernel schedule (default auto: op up to n = 16384)")
    ap.add_argument("--seed", type=int, default=0)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("demo", help="keygen->encrypt->decrypt + timings")
    p.add_argument("--time", action="store_true",
                   help="per-phase timings (chained slope)")
    p.add_argument("--mul", action="store_true",
                   help="also drive EvalMult + relinearization")
    p.set_defaults(fn=cmd_demo)

    p = sub.add_parser("ntt-test", help="polymul vs schoolbook golden model")
    p.add_argument("--n", type=int, default=2048)
    p.add_argument("--family", default="60bit", choices=["60bit", "30bit"])
    p.set_defaults(fn=cmd_ntt_test)

    p = sub.add_parser("decryption-test", help="reference golden vectors")
    p.add_argument("--fixtures", default="tests/fixtures")
    p.set_defaults(fn=cmd_decryption_test)

    p = sub.add_parser("keygen-test", help="ternary sampler histogram")
    p.add_argument("--samples", type=int, default=1 << 22)
    p.set_defaults(fn=cmd_keygen_test)

    p = sub.add_parser("keys", help="generate + save a keypair")
    p.add_argument("--out", default="keys.npz")
    p.set_defaults(fn=cmd_keys)

    p = sub.add_parser("encrypt", help="encrypt a message with saved keys")
    p.add_argument("--keys", default="keys.npz")
    p.add_argument("--out", default="ct.npz")
    p.add_argument("--message", default="ramp", choices=["ramp", "random"])
    p.set_defaults(fn=cmd_encrypt)

    p = sub.add_parser("decrypt", help="decrypt a saved ciphertext")
    p.add_argument("--keys", default="keys.npz")
    p.add_argument("--ct", default="ct.npz")
    p.set_defaults(fn=cmd_decrypt)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
