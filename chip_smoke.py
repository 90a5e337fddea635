"""Smoke run of the PyTorch/CUDA port (ntt_cuda_tpu_torch) on one card.

    python3 chip_smoke.py

Builds the CUDA kernels from ntt_cuda_tpu_torch/csrc with nvcc (sm_90a, one
nvcc per source, all started together) and, beside them, a probe whose
SASS gives the integer multiply instructions of one Shoup butterfly and
one Montgomery product (for each kernel's bound).  Then:

1. every kernel exactly (tolerance 0) against its plain PyTorch version on
   the card: the op kernels K1-K5 at 4k_3q and 16k_5q, K3-K5 also at
   32k_9q and 32k_16q (two 2^14 halves beside stage-0 passes), the stage
   kernels (7-10, 13) and the decrypt tail at 4k_3q, 16k_5q and 32k_9q
   (the 2^15 split), J = 1 and 3 where there is a batch axis, K2 also at
   32k_16q; the J-nonce keystream (kernel 6) at 32k_9q's encrypt size,
   J = 1 and 16, also against K1 row by row; the EvalMult kernels (BEHZ
   21a-c, kernel 11, the key switch 19) at 4k_3q, 16k_5q and 32k_9q,
   21a-c and 19 also at 32k_16q, J = 1 and 2; kernel 22 at n = 2^11,
   2^14, 2^15 (one block) and 2^16 (stage-0 passes beside two halves),
   (1, 1, n) and (16, 1, n), int32 and int64, forward and inverse, and
   equal to the 64-bit plain transform on the same modulus;
2. the reference's golden ciphertext, on both schedules;
3. the op schedule's main path at 16k_5q and the stage schedule's at
   32k_9q through the public API (keygen, encrypt of three seeded
   messages, decrypt, decrypt_batch; 32k_9q through
   `BFVContext.build(params)`, the default device and fusion), each with
   the launch counts set to 0 before it and read after it, its messages
   round-tripped and its keys and ciphertexts equal to the same calls on
   the CPU;
4. the EvalMult main path at 32k_9q through `BFVContext.build(params)`
   and at 16k_5q (keygen, relin_keygen, encrypt of two seeded messages,
   mul decrypted at L = 3, mul with rlk, square with rlk, decrypt), counts
   read as in 3, every product equal to the negacyclic m1 m2 mod t (exact
   through the plain NTT over the set's first modulus), and at 16k_5q
   every key and ciphertext equal to the same calls on the CPU;
5. a 32k_16q round trip, and 16k_5q under fusion="stage" equal to the op
   schedule;
6. batched encryption at 32k_9q (stage context) and 16k_5q (op): J = 16
   seeded messages, nonces 1..16, through encrypt_batch and
   decrypt_batch, counts read as in 3 (kernel 6 and K5 once each), every
   row equal to encrypt of its message and nonce and every message
   round-tripped;
7. the op schedule at 32k_9q (`fusion="op"`: K3-K5 over two halves),
   driven as in 3, its keys, ciphertexts and plaintexts equal to the stage
   schedule's;
8. the ciphertext ops at 32k_9q: add, sub, negate, add_plain, sub_plain
   and mul_plain by a seeded sparse plaintext decrypt to their mod-t
   results, mod_switch_to_next decrypts under next_context(), and
   noise_budget is positive and falls after mul_plain;
9. the CLI in-process on the default device, each command returning 0
   and printing PASS: `ntt-test --family 30bit --n 65536` (kernel 22's
   main path, counts read as in 3), `ntt-test --family 60bit --n 32768`,
   `decryption-test`, `keygen-test`, `--params 32k_9q demo --mul --time`,
   and `keys` / `encrypt` / `decrypt` at 16k_5q in a temporary directory;
10. the Galois path: at 32k_9q galois_keygen for {3, 2n - 1} and
   apply_galois decrypting to tau_g(m) mod t; the encrypted dot product
   (ntt_cuda_tpu_torch/examples, the batching encoder, mul + relin, 14
   rotations and a column swap) at n = 32768, every slot the expected
   value and the noise budget positive, counts read as in 3; and at
   n = 2048 its keys and ciphertexts equal to the same run on the CPU;
11. CUDA-event times: the 32k_9q ops and EvalMult ops, the 16k_5q EvalMult
   ops, the 16k_5q op-vs-stage and 32k_9q op-vs-stage A/Bs (in turns op,
   stage, stage, op), encrypt_batch at J = 16, galois_keygen (one
   element) and apply_galois at 32k_9q, ntt-test's product for both
   families and the whole dot product, each around one call; every kernel
   and its plain version around a run of calls back to back, beside the
   kernel's bound (K3-K5 and K5 at J = 16 also at 32k_9q; kernel 22 at
   (16, 1, n), n = 2^15 and 2^16, both directions).

Prints the card's name and power limit, one JSON line of per-kernel
results, and last `{"ok": true, "device": {...}}`.  Any failure raises,
so the exit code is not 0 and no result line is printed.  Imports no jax.
"""

from __future__ import annotations

import contextlib
import io
import json
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from ntt_cuda_tpu_torch import BFVContext, cli, cuda, get_bfv_params  # noqa: E402
from ntt_cuda_tpu_torch.examples import (  # noqa: E402
    encrypted_dot_product as example)
from ntt_cuda_tpu_torch.ops import (behz_kernels, bfv_tail,  # noqa: E402
                                    fused_ops, ntt, ntt30, ntt_stage, poly,
                                    salsa20, sampling)
from ntt_cuda_tpu_torch.params import get_params  # noqa: E402
from ntt_cuda_tpu_torch.utils.profiling import median_ms  # noqa: E402

SEED = 20261016
OP_SET = "16k_5q"        # the op schedule's main path (n <= 16384)
STAGE_SET = "32k_9q"     # the stage schedule's main path (n = 32768)
MULT_SETS = ("32k_9q", "16k_5q")  # the EvalMult main path, timed at both
OP_CHECK_SETS = ("4k_3q", "16k_5q")
STAGE_CHECK_SETS = ("4k_3q", "16k_5q", "32k_9q")
MULT_CHECK_SETS = ("4k_3q", "16k_5q", "32k_9q", "32k_16q")
OP32_CHECK_SETS = ("32k_9q", "32k_16q")   # K3-K5 over two 2^14 halves
OP32_KERNELS = ("half_polymul", "keygen_fused", "encrypt_fused")
BATCH_J = 16
NTT30_SIZES = (2048, 16384, 32768, 65536)   # one block up to 2^15; 2^16
NTT30_BATCH = 16                            # bench.py's 16 polynomials
DOT_N = 32768                               # the dot product at full width,
DOT_R = 4        # over four 45-bit moduli: three fail EvalMult's aux-base
#                  bound at n = 32768, t = 65537 (ops/behz.py, as in JAX)
# the kernels the Galois path must launch: K1, 7, 8, 11, 19 and K2
GALOIS_NEED = ("salsa20_keystream", "ntt_transform", "ntt_inverse_mul",
               "ntt_forward_addneg", "keyswitch_fused", "decrypt_tail")
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
SMS, IMAD_PER_CLOCK = 132, 64  # 32-bit integer multiplies per SM per clock

# name -> (wrappers, CUDA source, the TPU kernel it replaces, the main
# paths that run it; its `launches` are the first path's: the EvalMult
# path's wherever it runs the kernel)
KERNELS = {
    "salsa20_keystream": ((salsa20.keystream_block_words,),
                          "ntt_cuda_tpu_torch/csrc/salsa20.cu",
                          "ntt_cuda_tpu/ops/salsa20.py:174",
                          ("mult", "op", "stage", "op32")),
    "salsa20_keystream_batch": ((salsa20.keystream_block_words_batch,),
                                "ntt_cuda_tpu_torch/csrc/salsa20.cu",
                                "ntt_cuda_tpu/ops/salsa20.py:249",
                                ("batch",)),
    "decrypt_tail": ((bfv_tail.decrypt_tail,),
                     "ntt_cuda_tpu_torch/csrc/decrypt_tail.cu",
                     "ntt_cuda_tpu/ops/bfv_tail.py:388",
                     ("mult", "op", "stage", "batch", "op32")),
    "half_polymul": ((fused_ops.half_polymul,),
                     "ntt_cuda_tpu_torch/csrc/fused_ops.cu",
                     "ntt_cuda_tpu/ops/fused_ops.py:213", ("op", "op32")),
    "keygen_fused": ((fused_ops.keygen_fused,),
                     "ntt_cuda_tpu_torch/csrc/fused_ops.cu",
                     "ntt_cuda_tpu/ops/fused_ops.py:137", ("op", "op32")),
    "encrypt_fused": ((fused_ops.encrypt_fused,),
                      "ntt_cuda_tpu_torch/csrc/fused_ops.cu",
                      "ntt_cuda_tpu/ops/fused_ops.py:466",
                      ("op", "batch", "op32")),
    # kernel 7, both directions (one TPU kernel with an `inverse` flag);
    # its times below are the forward's, the direction the main path runs
    "ntt_transform": ((ntt_stage.ntt_forward, ntt_stage.ntt_inverse),
                      "ntt_cuda_tpu_torch/csrc/ntt_stage.cu",
                      "ntt_cuda_tpu/ops/ntt_pallas.py:558",
                      ("mult", "stage")),
    "ntt_inverse_mul": ((ntt_stage.ntt_inverse_mul,),
                        "ntt_cuda_tpu_torch/csrc/ntt_stage.cu",
                        "ntt_cuda_tpu/ops/ntt_pallas.py:685",
                        ("mult", "stage")),
    "ntt_forward_ternary": ((ntt_stage.ntt_forward_ternary,),
                            "ntt_cuda_tpu_torch/csrc/ntt_stage.cu",
                            "ntt_cuda_tpu/ops/ntt_pallas.py:782",
                            ("mult", "stage")),
    "ntt_forward_addneg_gauss": ((ntt_stage.ntt_forward_addneg_gauss,),
                                 "ntt_cuda_tpu_torch/csrc/ntt_stage.cu",
                                 "ntt_cuda_tpu/ops/ntt_pallas.py:959",
                                 ("mult", "stage")),
    "encrypt_fused_stage": ((bfv_tail.encrypt_fused,),
                            "ntt_cuda_tpu_torch/csrc/ntt_stage.cu",
                            "ntt_cuda_tpu/ops/bfv_tail.py:661",
                            ("mult", "stage")),
    "ntt_forward_addneg": ((ntt_stage.ntt_forward_addneg,),
                           "ntt_cuda_tpu_torch/csrc/ntt_stage.cu",
                           "ntt_cuda_tpu/ops/ntt_pallas.py:868", ("mult",)),
    # three launches: two of ntt_stage.cu and fused_ops.cu's tail
    "keyswitch_fused": ((fused_ops.keyswitch_fused,),
                        "ntt_cuda_tpu_torch/csrc/ntt_stage.cu",
                        "ntt_cuda_tpu/ops/fused_ops.py:651", ("mult",)),
    "behz_rns_to_bsk": ((behz_kernels.rns_to_bsk,),
                        "ntt_cuda_tpu_torch/csrc/behz.cu",
                        "ntt_cuda_tpu/ops/behz_pallas.py:183", ("mult",)),
    "behz_fast_floor": ((behz_kernels.fast_floor,),
                        "ntt_cuda_tpu_torch/csrc/behz.cu",
                        "ntt_cuda_tpu/ops/behz_pallas.py:227", ("mult",)),
    "behz_bsk_to_q": ((behz_kernels.bsk_to_q,),
                      "ntt_cuda_tpu_torch/csrc/behz.cu",
                      "ntt_cuda_tpu/ops/behz_pallas.py:258", ("mult",)),
    # kernel 22, both directions; its times below are the forward's at
    # (16, 1, 65536)
    "ntt30_transform": ((ntt30.ntt_forward, ntt30.ntt_inverse),
                        "ntt_cuda_tpu_torch/csrc/ntt30.cu",
                        "ntt_cuda_tpu/ops/ntt_pallas30.py:257", ("cli30",)),
}

# One multiply-heavy primitive per probe kernel; its SASS gives the
# primitive's integer multiply instructions.
PROBE_SRC = r"""
#include "modarith.cuh"
extern "C" __global__ void probe_shoup(const u64* a, u64* o) {
  o[0] = mul_shoup(a[0], a[1], a[2], a[3]);
}
extern "C" __global__ void probe_mont(const u64* a, u64* o) {
  o[0] = mont_mul(a[0], a[1], a[2], a[3]);
}
extern "C" __global__ void probe_mod_nu(const u64* a, u64* o) {
  o[0] = mod_nu(a[0], a[1], a[2]);
}
extern "C" __global__ void probe_mullo(const u64* a, u64* o) {
  o[0] = a[0] * a[1];
}
extern "C" __global__ void probe_mul32(const u64* a, u64* o) {
  o[0] = (u32)a[0] * (u32)a[1];
}
extern "C" __global__ void probe_shoup32(const u32* a, u32* o) {
  o[0] = mul_shoup32(a[0], a[1], a[2], a[3]);
}
"""


def log(msg: str) -> None:
    print(msg, flush=True)


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def start_probe() -> tuple[subprocess.Popen, Path]:
    out = ROOT / "build" / "sass_probe"
    out.mkdir(parents=True, exist_ok=True)
    (out / "probe.cu").write_text(PROBE_SRC)
    cubin = out / "probe.cubin"
    cmd = [cuda.find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
           "-cubin", "-I", str(cuda.CSRC), "-o", str(cubin),
           str(out / "probe.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), cubin


def probe_mults(proc: subprocess.Popen, cubin: Path) -> dict[str, int]:
    """Integer multiply instructions (IMAD, IMAD.WIDE, IMAD.HI, IMAD.X,
    IMUL; not the IMAD.MOV / .SHL / .IADD forms, which move, shift or add)
    in each probe kernel's SASS."""
    out = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc (SASS probe) failed:\n{out}")
    cuobjdump = Path(cuda.find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(cubin)],
                          capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : probe_(\w+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = 0
            continue
        m = re.search(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if fn and m:
            op = m.group(1)
            if op.startswith(("IMAD", "IMUL")) and not any(
                    k in op for k in (".MOV", ".SHL", ".IADD")):
                counts[fn] += 1
    if sorted(counts) != ["mod_nu", "mont", "mul32", "mullo", "shoup",
                          "shoup32"]:
        raise RuntimeError(f"SASS probe: functions {sorted(counts)}")
    return counts


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


def kernel_ms(fn, reps: int = 20, runs: int = 3) -> float:
    """Time per call of `reps` calls back to back, from CUDA events around
    the run (the host's launch latency hides behind the device wherever
    the device is the slower); the median of `runs` runs."""
    fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def rand_res(rng, qs, n, lead, device):
    return torch.from_numpy(np.stack(
        [rng.integers(0, q, lead + (n,), dtype=np.int64) for q in qs],
        axis=-2)).to(device)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


class Work:
    """Bytes a function must move (each input read once, each output
    written once) and integer multiply instructions it must issue, in
    units of the probed primitives: `shoup`, `mont`, `mod_nu`, `mullo`,
    `mul32`, `shoup32`."""

    def __init__(self, nbytes: int, **prims):
        self.nbytes, self.prims = nbytes, prims

    def terms(self, mults: dict, clock_hz: float) -> dict:
        """The two times, in ms, whose larger is the bound."""
        imads = sum(mults[k] * v for k, v in self.prims.items())
        return {"bytes": self.nbytes, "imads": imads,
                "bytes_ms": self.nbytes / HBM_BYTES_PER_S * 1e3,
                "ops_ms": imads / (SMS * IMAD_PER_CLOCK * clock_hz) * 1e3}

    def bound(self, mults: dict, clock_hz: float) -> tuple[float, str]:
        """The bound in ms, and which term sets it."""
        t = self.terms(mults, clock_hz)
        by_bytes = t["bytes_ms"] >= t["ops_ms"]
        return (max(t["bytes_ms"], t["ops_ms"]),
                "bytes" if by_bytes else "operations")


def tables(tb, which: str = "both") -> list:
    """The tables a transform reads: the psi ("fwd") or psi^-1 ("inv")
    powers with their Shoup companions, or both, and the consts."""
    fw, iv = [tb.psi, tb.psi_shoup], [tb.psiinv, tb.psiinv_shoup]
    return {"fwd": fw, "inv": iv, "both": fw + iv}[which] + [tb.consts]


def transform_butterflies(polys: int, n: int) -> int:
    return polys * (n // 2) * (n.bit_length() - 1)


def keystream_batch_cases(p, dev):
    """(kernel, J, wrapper call, plain call, Work) for kernel 6 at the
    shapes encrypt_batch gives it at p: the encrypt stream's blocks for
    the mapped nonces of 1..J, J = 1 and BATCH_J."""
    nb = (sampling.encrypt_entropy_bytes(p.n) + 63) // 64
    cases = []
    for J in (1, BATCH_J):
        ns = sampling.encrypt_nonces(range(1, J + 1))
        cases.append((
            "salsa20_keystream_batch", J,
            lambda ns=ns: salsa20.keystream_block_words_batch(nb, ns,
                                                              device=dev),
            lambda ns=ns: salsa20.keystream_batch_plain(nb, ns, device=dev),
            Work(8 * J * 16 * nb)))
    return cases


def op_cases(ctx: BFVContext, rng, dev):
    """(kernel, J, wrapper call, plain call, Work) for K1-K5 at the shapes
    the op schedule's main path gives each, J = 1 and 3 where a batch dim
    exists."""
    p = ctx.params
    n, r = p.n, p.r
    cases = []
    kg_blocks = (sampling.keygen_entropy_bytes(n, r) + 63) // 64
    enc_blocks = (sampling.encrypt_entropy_bytes(n) + 63) // 64
    for nb, with_u64 in ((kg_blocks, True), (enc_blocks, False)):
        kw = dict(nonce=3, with_u64=with_u64, device=dev)
        cases.append(("salsa20_keystream", nb,
                      lambda nb=nb, kw=kw: salsa20.keystream_block_words(nb, **kw),
                      lambda nb=nb, kw=kw: salsa20.keystream_plain(nb, **kw),
                      Work(8 * nb * (24 if with_u64 else 16))))
    s_b, a, e_d = sampling.keygen_draws_compact(n, r, ctx.tables_full.ms,
                                                nonce=1)
    tf, td = ctx.tables_full, ctx.tables_drop
    bf = transform_butterflies(r, n)
    cases.append(("keygen_fused", 1,
                  lambda: fused_ops.keygen_fused(s_b, a, e_d, tf),
                  lambda: fused_ops.keygen_fused_plain(s_b, a, e_d, tf),
                  Work(nbytes(s_b, a, e_d, *tables(tf)) + 2 * nbytes(a),
                       shoup=3 * bf + r * n, mont=r * n)))
    sk, pk0 = fused_ops.keygen_fused(s_b, a, e_d, tf)
    pk = torch.stack([pk0, a])
    sk_drop = sk[: r - 1].contiguous()
    dt, tc = ctx.dec_tail_consts, ctx.tail_consts
    for J in (1, 3):
        lead = () if J == 1 else (J,)
        x = rand_res(rng, p.q[:-1], n, lead, dev)
        c0 = rand_res(rng, p.q[:-1], n, lead, dev)
        bfd = transform_butterflies(J * (r - 1), n)
        cases.append(("half_polymul", J,
                      lambda x=x: fused_ops.half_polymul(x, sk_drop, td),
                      lambda x=x: fused_ops.half_polymul_plain(x, sk_drop, td),
                      Work(nbytes(x, sk_drop, *tables(td), x),
                           shoup=2 * bfd + x.numel(), mont=x.numel())))
        cases.append(("decrypt_tail", J,
                      lambda x=x, c0=c0: bfv_tail.decrypt_tail(x, c0, dt),
                      lambda x=x, c0=c0: bfv_tail.decrypt_tail_plain(x, c0, dt),
                      decrypt_tail_work(x, c0, dt, J * n)))
        draws = [sampling.encrypt_draws_compact(n, nonce=k + 1, device=dev)
                 for k in range(J)]
        u_b = torch.stack([d[0] for d in draws])
        e2 = torch.stack([d[1] for d in draws])
        m = torch.from_numpy(rng.integers(0, p.t, (J, n))).to(dev)
        if J == 1:
            u_b, e2, m = u_b[0], e2[0], m[0]
        cases.append(("encrypt_fused", J,
                      lambda u=u_b, e=e2, m=m: fused_ops.encrypt_fused(
                          u, pk, e, m, tf, tc),
                      lambda u=u_b, e=e2, m=m: fused_ops.encrypt_fused_plain(
                          u, pk, e, m, tf, tc),
                      encrypt_work(ctx, u_b, pk, e2, m, J)))
    return cases


def encrypt_work(ctx: BFVContext, u_b, pk, e2, m, J: int) -> Work:
    """K5 over J messages: r forward and 2r inverse transforms per message,
    two Montgomery products and two Shoup n^-1 per (h, modulus,
    coefficient), then the tail per output coefficient."""
    n, r = ctx.params.n, ctx.params.r
    tf, tc = ctx.tables_full, ctx.tail_consts
    out_coefs = J * 2 * (r - 1) * n
    return Work(nbytes(u_b, pk, e2, m, *tables(tf), tc.per_mod) + 8 * out_coefs,
                shoup=3 * transform_butterflies(J * r, n) + 2 * J * r * n,
                mont=2 * J * r * n + out_coefs,
                mod_nu=out_coefs + out_coefs // 2, mullo=out_coefs // 2)


def decrypt_tail_work(x, c0, dt, coefs: int) -> Work:
    """Per coefficient and kept residue: two Montgomery products mod q_i,
    one mod gamma and one 64-bit multiply by bcm_t; per coefficient one
    more of each (pow2 t)."""
    rk = x.shape[-2]
    return Work(nbytes(x, c0, dt.per_mod, dt.glob) + 8 * coefs,
                mont=coefs * (3 * rk + 1), mullo=coefs * (rk + 1))


def stage_cases(ctx: BFVContext, rng, dev):
    """(kernel, J, wrapper call, plain call, Work) for the stage kernels at
    the shapes the stage schedule's main path gives each (keygen: x (r, n);
    decrypt: (J, r-1, n) against a shared sk), J = 1 and 3, and the
    decrypt tail at (J, r-1, n)."""
    p = ctx.params
    n, r = p.n, p.r
    tf, td, tc, dt = (ctx.tables_full, ctx.tables_drop, ctx.tail_consts,
                      ctx.dec_tail_consts)
    cases = []
    for J in (1, 3):
        lead = () if J == 1 else (J,)
        x = rand_res(rng, p.q[:-1], n, lead, dev)
        y = rand_res(rng, p.q[:-1], n, (), dev)
        xf = rand_res(rng, p.q, n, lead, dev)
        d = torch.from_numpy(rng.integers(-19, 17, lead + (n,))
                             .astype(np.int32)).to(dev)
        t = d.clamp(-1, 2)
        bd = transform_butterflies(J * (r - 1), n)
        bf = transform_butterflies(J * r, n)
        cases += [
            ("ntt_forward", J, lambda x=x: ntt_stage.ntt_forward(x, td),
             lambda x=x: ntt_stage.ntt_forward_plain(x, td),
             Work(nbytes(x, *tables(td, "fwd"), x), shoup=bd)),
            ("ntt_inverse", J, lambda x=x: ntt_stage.ntt_inverse(x, td),
             lambda x=x: ntt_stage.ntt_inverse_plain(x, td),
             Work(nbytes(x, *tables(td, "inv"), x), shoup=bd,
                  mont=x.numel())),
            ("ntt_inverse_mul", J,
             lambda x=x, y=y: ntt_stage.ntt_inverse_mul(x, y, td),
             lambda x=x, y=y: ntt_stage.ntt_inverse_mul_plain(x, y, td),
             Work(nbytes(x, y, *tables(td, "inv"), x), shoup=bd + x.numel(),
                  mont=x.numel())),
            ("ntt_forward_ternary", J,
             lambda t=t: ntt_stage.ntt_forward_ternary(t, tf),
             lambda t=t: ntt_stage.ntt_forward_ternary_plain(t, tf),
             Work(nbytes(t, *tables(tf, "fwd"), xf), shoup=bf)),
            ("ntt_forward_addneg_gauss", J,
             lambda xf=xf, d=d: ntt_stage.ntt_forward_addneg_gauss(xf, d, tf),
             lambda xf=xf, d=d: ntt_stage.ntt_forward_addneg_gauss_plain(
                 xf, d, tf),
             Work(nbytes(xf, d, *tables(tf, "fwd"), xf), shoup=bf)),
            ("decrypt_tail", J,
             lambda x=x: bfv_tail.decrypt_tail(x, x, dt),
             lambda x=x: bfv_tail.decrypt_tail_plain(x, x, dt),
             decrypt_tail_work(x, x, dt, J * n)),
        ]
    _, pk = ctx.keygen(nonce=1)
    u_ntt = ntt_stage.ntt_forward_ternary(
        torch.from_numpy(rng.integers(-1, 3, n).astype(np.int32)).to(dev), tf)
    e2 = torch.from_numpy(rng.integers(-19, 17, (2, n)).astype(np.int32)).to(dev)
    m = torch.from_numpy(rng.integers(0, p.t, n)).to(dev)
    out_coefs = 2 * (r - 1) * n
    cases.append((
        "encrypt_fused_stage", 1,
        lambda: bfv_tail.encrypt_fused(u_ntt, pk, e2, m, tf, tc),
        lambda: bfv_tail.encrypt_fused_plain(u_ntt, pk, e2, m, tf, tc),
        Work(nbytes(u_ntt, pk, e2, m, *tables(tf, "inv"), tc.per_mod)
             + 8 * out_coefs,
             shoup=transform_butterflies(2 * r, n) + 2 * r * n,
             mont=2 * r * n + out_coefs, mod_nu=out_coefs + out_coefs // 2,
             mullo=out_coefs // 2)))
    return cases


def mult_cases(ctx: BFVContext, rng, dev, addneg: bool = True):
    """(kernel, J, wrapper call, plain call, Work) for the EvalMult kernels
    at the shapes the EvalMult path gives each: 21a over both operands of
    mul (J, 2, 2, k, n), 21b and 21c over the three tensor-product
    components (J, 3, ., n), the key switch of c2 (J, k, n), J = 1 and 2;
    with `addneg`, kernel 11 over relin_keygen's (k, r, n)."""
    p = ctx.params
    n, r, k = p.n, p.r, p.r - 1
    st = ctx._mult_setup()
    mb, tf, tc = st.banks, ctx.tables_full, ctx.tail_consts
    banks = [mb.qsrc, mb.tgt, mb.amat, mb.bsrc, mb.bmat, mb.bfin, mb.glob]
    cases = []
    for J in (1, 2):
        lead = () if J == 1 else (J,)
        xa = rand_res(rng, p.q[:-1], n, lead + (2, 2), dev)
        xq = rand_res(rng, p.q[:-1], n, lead + (3,), dev)
        xb = rand_res(rng, st.aux.bsk, n, lead + (3,), dev)
        ca, cf = xa.numel() // (k * n), xq.numel() // (k * n)
        coefs_a, coefs_f = ca * n, cf * n
        cases += [
            ("behz_rns_to_bsk", J,
             lambda x=xa: behz_kernels.rns_to_bsk(x, mb),
             lambda x=xa: behz_kernels.rns_to_bsk_plain(x, mb),
             Work(nbytes(xa, *banks) + 8 * coefs_a * (k + 1),
                  shoup=coefs_a * (k + (k + 1) * (k + 2)),
                  mul32=coefs_a * (k + 1))),
            ("behz_fast_floor", J,
             lambda a=xq, b=xb: behz_kernels.fast_floor(a, b, mb),
             lambda a=xq, b=xb: behz_kernels.fast_floor_plain(a, b, mb),
             Work(nbytes(xq, xb, *banks) + nbytes(xb),
                  shoup=coefs_f * (k + (k + 1) * (k + 2)))),
            ("behz_bsk_to_q", J,
             lambda b=xb: behz_kernels.bsk_to_q(b, mb),
             lambda b=xb: behz_kernels.bsk_to_q_plain(b, mb),
             Work(nbytes(xb, *banks) + nbytes(xq),
                  shoup=coefs_f * (2 * k + 1 + k * (k + 1)))),
        ]
        c2 = rand_res(rng, p.q[:-1], n, lead, dev)
        ksk = rand_res(rng, p.q, n, (2, k), dev)
        out_coefs = J * 2 * k * n
        cases.append((
            "keyswitch_fused", J,
            lambda c=c2, s=ksk: fused_ops.keyswitch_fused(c, s, tf, tc),
            lambda c=c2, s=ksk: fused_ops.keyswitch_fused_plain(c, s, tf, tc),
            Work(nbytes(c2, ksk, *tables(tf), tc.per_mod) + 8 * out_coefs,
                 shoup=transform_butterflies(J * (k + 2) * r, n) + J * 2 * r * n,
                 mod_nu=J * k * r * n + out_coefs,
                 mont=J * 2 * r * n * k + out_coefs)))
    if addneg:
        x = rand_res(rng, p.q, n, (k,), dev)
        e = rand_res(rng, p.q, n, (k,), dev)
        cases.append((
            "ntt_forward_addneg", 1,
            lambda: ntt_stage.ntt_forward_addneg(x, e, tf),
            lambda: ntt_stage.ntt_forward_addneg_plain(x, e, tf),
            Work(nbytes(x, e, *tables(tf, "fwd"), x),
                 shoup=transform_butterflies(k * r, n))))
    return cases


def negacyclic_mod_t(m1, m2, p, dev) -> torch.Tensor:
    """m1 * m2 in Z_t[x]/(x^n + 1), exact: the product through the plain NTT
    over the set's first modulus q0 (every coefficient of the integer
    product has |c| <= n t^2, far below q0 / 2), centered, then mod t."""
    q0 = p.q[0]
    tb = ntt.NTTTables.build([q0], [p.psi[0]], p.n, dev)
    f = [ntt.ntt_forward(torch.as_tensor(m, device=dev).reshape(1, -1), tb)
         for m in (m1, m2)]
    c = ntt.ntt_inverse(ntt.dyadic_mul(f[0], f[1], tb.ms), tb)[0]
    if p.n * p.t * p.t >= q0 // 2:
        raise AssertionError(f"{p.name}: n t^2 does not fit q0 / 2")
    return torch.remainder(torch.where(c > q0 // 2, c - q0, c), p.t)


def drive_mult(ctx: BFVContext, msgs: np.ndarray, dev=None) -> dict:
    """keygen, relin_keygen, encrypt of two messages, mul (decrypted at
    L = 3), mul with rlk, square with rlk, and their decrypts."""
    sk, pk = ctx.keygen(nonce=1)
    rlk = ctx.relin_keygen(sk, nonce=1)
    cts = [ctx.encrypt(pk, msgs[j], nonce=j + 1) for j in range(2)]
    ct3 = ctx.mul(cts[0], cts[1])
    ct2 = ctx.mul(cts[0], cts[1], rlk=rlk)
    sq = ctx.square(cts[0], rlk=rlk)
    outs = {"mul_l3": ctx.decrypt(sk, ct3), "mul_relin": ctx.decrypt(sk, ct2),
            "square_relin": ctx.decrypt(sk, sq)}
    if dev is not None:
        torch.cuda.synchronize(dev)
    return dict(sk=sk, pk=pk, rlk=rlk, cts=cts, ct3=ct3, ct2=ct2, sq=sq,
                outs=outs)


def check_mult(p, res: dict, msgs: np.ndarray, dev,
               ref: dict | None = None) -> None:
    """Each decrypt equal to the exact negacyclic product mod t; with
    `ref` (the same calls on the CPU) every key and ciphertext equal."""
    name = p.name
    prod12 = negacyclic_mod_t(msgs[0], msgs[1], p, dev)
    prod11 = negacyclic_mod_t(msgs[0], msgs[0], p, dev)
    for key, want in (("mul_l3", prod12), ("mul_relin", prod12),
                      ("square_relin", prod11)):
        got = res["outs"][key]
        if got.shape != (p.n,) or not torch.equal(got.to(dev), want):
            raise AssertionError(f"{name}: {key} does not decrypt to the "
                                 f"negacyclic product mod t")
    if ref is None:
        return
    for key in ("sk", "pk", "rlk", "ct3", "ct2", "sq"):
        if not torch.equal(res[key].cpu(), ref[key].cpu()):
            raise AssertionError(f"{name}: {key} != the CPU run")
    if not all(torch.equal(a.cpu(), b.cpu())
               for a, b in zip(res["cts"], ref["cts"])):
        raise AssertionError(f"{name}: ciphertexts != the CPU run")


def mult_times(ctx: BFVContext, res: dict, reps: int) -> dict:
    sk, rlk, (a, b), ct3 = res["sk"], res["rlk"], res["cts"], res["ct3"]
    return {
        "mul": median_ms(lambda: ctx.mul(a, b), reps),
        "mul_relin": median_ms(lambda: ctx.mul(a, b, rlk=rlk), reps),
        "square": median_ms(lambda: ctx.square(a), reps),
        "relin_keygen": median_ms(lambda: ctx.relin_keygen(sk, nonce=1),
                                  reps),
        "relinearize": median_ms(lambda: ctx.relinearize(ct3, rlk), reps),
    }


def drive_batch(ctx: BFVContext, msgs: np.ndarray, dev) -> dict:
    """keygen, then the counted run: encrypt_batch of the J messages with
    nonces 1..J and decrypt_batch; then encrypt of each message alone."""
    sk, pk = ctx.keygen(nonce=1)
    m = torch.from_numpy(msgs).to(dev)
    nonces = list(range(1, len(msgs) + 1))
    torch.cuda.synchronize(dev)
    reset_counts()
    cts = ctx.encrypt_batch(pk, m, nonces)
    outb = ctx.decrypt_batch(sk, cts)
    torch.cuda.synchronize(dev)
    cnt = read_counts()
    each = torch.stack([ctx.encrypt(pk, m[j], nonce=nonces[j])
                        for j in range(len(msgs))])
    return dict(sk=sk, pk=pk, m=m, nonces=nonces, cts=cts, outb=outb,
                each=each, counts=cnt)


def check_ctops(ctx: BFVContext, res: dict, msgs: np.ndarray, dev) -> dict:
    """add, sub, negate, add_plain, sub_plain, mul_plain by a seeded sparse
    plaintext and mod_switch_to_next decrypt to their mod-t results;
    noise_budget is positive and falls after mul_plain."""
    p = ctx.params
    sk, (c1, c2) = res["sk"], res["cts"][:2]
    m1, m2 = (torch.from_numpy(msgs[j]).to(dev) for j in range(2))
    rng = np.random.default_rng(SEED + 4)
    sparse = np.zeros(p.n, np.int64)
    sparse[rng.choice(p.n, 4, replace=False)] = rng.integers(1, p.t, 4)
    cm = ctx.mul_plain(c1, sparse)
    got = {
        "add": (ctx.add(c1, c2), (m1 + m2) % p.t),
        "sub": (ctx.sub(c1, c2), (m1 - m2) % p.t),
        "negate": (ctx.negate(c1), (-m1) % p.t),
        "add_plain": (ctx.add_plain(c1, m2), (m1 + m2) % p.t),
        "sub_plain": (ctx.sub_plain(c1, m2), (m1 - m2) % p.t),
        "mul_plain": (cm, negacyclic_mod_t(msgs[0], sparse, p, dev)),
    }
    for op, (ct, want) in got.items():
        if not torch.equal(ctx.decrypt(sk, ct), want):
            raise AssertionError(f"{p.name}: {op} does not decrypt to its "
                                 f"mod-t result")
    low = ctx.mod_switch_to_next(c1)
    if (tuple(low.shape) != (2, p.r - 2, p.n)
            or not torch.equal(ctx.next_context().decrypt(sk, low), m1)):
        raise AssertionError(f"{p.name}: mod_switch_to_next does not "
                             f"decrypt under next_context()")
    budget = {"fresh": ctx.noise_budget(sk, c1),
              "after_mul_plain": ctx.noise_budget(sk, cm)}
    if not 0 < budget["after_mul_plain"] < budget["fresh"]:
        raise AssertionError(f"{p.name}: noise budgets {budget}")
    return budget


def ntt30_work(x, tb, inverse: bool) -> Work:
    """Kernel 22 over x: one table and its companions read, x read and
    written once; a 32-bit Shoup multiply per butterfly, and per
    coefficient for the inverse's n^-1."""
    tabs = [tb.psiinv, tb.psiinv_shoup] if inverse else [tb.psi,
                                                          tb.psi_shoup]
    shoups = transform_butterflies(x.numel() // tb.n, tb.n)
    return Work(nbytes(x, *tabs, tb.consts, x),
                shoup32=shoups + (x.numel() if inverse else 0))


def ntt30_checks(dev, rng, errs: dict) -> dict:
    """Kernel 22 against its plain version and the 64-bit plain transform
    at every size and shape; returns the (16, 1, n) int32 timing cases at
    2^15 and 2^16 by (n, direction)."""
    timing = {}
    for n in NTT30_SIZES:
        q, psi, *_ = get_params(n, "30bit")
        tb = ntt30.NTTTables30.build([q], [psi], n, dev)
        tb64 = ntt.NTTTables.build([q], [psi], n, dev)
        for lead in ((1, 1), (NTT30_BATCH, 1)):
            x = torch.from_numpy(rng.integers(0, q, lead + (n,))).to(dev)
            ref64 = ntt.ntt_forward(x, tb64)
            for dtype in (torch.int32, torch.int64):
                xd = x.to(dtype)
                f = ntt30.ntt_forward(xd, tb)
                compare("ntt30_transform", f, ntt30.ntt_forward_plain(xd, tb),
                        errs)
                compare("ntt30_transform", f.to(torch.int64), ref64, errs)
                i = ntt30.ntt_inverse(f, tb)
                compare("ntt30_transform", i,
                        ntt30.ntt_inverse_plain(f, tb), errs)
                compare("ntt30_transform", i, xd, errs)
            log(f"check ntt30_transform n={n} {lead + (n,)} int32/int64 "
                f"fwd/inv: equal to the plain versions and the 64-bit "
                f"transform")
            if lead[0] == NTT30_BATCH and n >= 32768:
                x32 = x.to(torch.int32)
                f32 = ntt30.ntt_forward(x32, tb)
                timing[(n, "fwd")] = (
                    lambda x32=x32, tb=tb: ntt30.ntt_forward(x32, tb),
                    lambda x32=x32, tb=tb: ntt30.ntt_forward_plain(x32, tb),
                    ntt30_work(x32, tb, False))
                timing[(n, "inv")] = (
                    lambda f32=f32, tb=tb: ntt30.ntt_inverse(f32, tb),
                    lambda f32=f32, tb=tb: ntt30.ntt_inverse_plain(f32, tb),
                    ntt30_work(f32, tb, True))
    return timing


def run_cli(argv: list[str], passes: int = 0) -> str:
    """cli.main(argv) in this process; raises unless it returns 0, prints
    no FAIL and at least `passes` PASS lines.  Returns its output."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    out = buf.getvalue()
    for line in out.splitlines():
        log(f"  {line}")
    if rc != 0 or "FAIL" in out or out.count("PASS") < passes:
        raise AssertionError(f"cli {' '.join(argv)}: rc {rc}, output "
                             f"{out!r}")
    return out


def tau_mod_t(m, g: int, p, dev) -> torch.Tensor:
    """tau_g of a plaintext m (n,) in Z_t[x]/(x^n + 1)."""
    perm, neg = poly.galois_maps(p.n, g)
    y = torch.as_tensor(m, device=dev)[torch.from_numpy(
        perm.astype(np.int64)).to(dev)]
    return torch.where(torch.from_numpy(neg).to(dev), (p.t - y) % p.t, y)


def check_dot(name: str, out: dict, dev) -> None:
    """Every slot of the folded ciphertext holds the dot product, the
    noise budget is positive, and everything lives on `dev`."""
    want = torch.full_like(out["slots"], out["expected"])
    if not (out["result"] == out["expected"]
            and torch.equal(out["slots"], want) and out["budget"] > 0):
        raise AssertionError(f"{name}: dot product {out['result']} "
                             f"(expected {out['expected']}), budget "
                             f"{out['budget']}")
    if out["ct"].device != dev:
        raise AssertionError(f"{name}: ran on {out['ct'].device}")


def reset_counts() -> None:
    for wrappers, *_ in KERNELS.values():
        for w in wrappers:
            w.launches = 0


def read_counts() -> dict[str, int]:
    return {k: sum(w.launches for w in ws) for k, (ws, *_) in KERNELS.items()}


def drive(ctx: BFVContext, msgs: np.ndarray, dev=None) -> dict:
    """keygen, encrypt of each message, decrypt of each, decrypt_batch."""
    sk, pk = ctx.keygen(nonce=1)
    cts = [ctx.encrypt(pk, msgs[j], nonce=j + 1) for j in range(len(msgs))]
    outs = [ctx.decrypt(sk, c) for c in cts]
    outb = ctx.decrypt_batch(sk, torch.stack(cts))
    if dev is not None:
        torch.cuda.synchronize(dev)
    return dict(sk=sk, pk=pk, cts=cts, outs=outs, outb=outb)


def check_path(name: str, res: dict, msgs: np.ndarray, ref: dict) -> None:
    """Round trip of every message, decrypt_batch agreeing, and keys and
    ciphertexts equal to `ref` (the same calls on the CPU)."""
    for j in range(len(msgs)):
        if not np.array_equal(res["outs"][j].cpu().numpy(), msgs[j]):
            raise AssertionError(f"{name}: decrypt(encrypt(m{j})) != m{j}")
    if not np.array_equal(res["outb"].cpu().numpy(), msgs):
        raise AssertionError(f"{name}: decrypt_batch != messages")
    same = (torch.equal(res["sk"].cpu(), ref["sk"].cpu())
            and torch.equal(res["pk"].cpu(), ref["pk"].cpu())
            and all(torch.equal(a.cpu(), b.cpu())
                    for a, b in zip(res["cts"], ref["cts"])))
    if not same:
        raise AssertionError(f"{name}: keys/ciphertexts != the reference run")


def op_times(ctx: BFVContext, res: dict, msgs: np.ndarray, reps: int) -> dict:
    sk, pk, cts = res["sk"], res["pk"], res["cts"]
    m0 = torch.from_numpy(msgs[0]).to(ctx.device)
    batch = torch.stack(cts)
    return {
        "keygen": median_ms(lambda: ctx.keygen(nonce=1), reps),
        "encrypt": median_ms(lambda: ctx.encrypt(pk, m0, nonce=1), reps),
        "decrypt": median_ms(lambda: ctx.decrypt(sk, cts[0]), reps),
        "decrypt_batch_J3": median_ms(lambda: ctx.decrypt_batch(sk, batch),
                                      reps),
    }


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA card; "
                           "torch.cuda.is_available() is False")
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    log(smi("name,power.limit"))
    clock_hz = float(smi("clocks.max.sm").split()[0]) * 1e6
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} max SM clock "
        f"{clock_hz / 1e6:.0f} MHz")

    t0 = time.perf_counter()
    probe = start_probe()
    cuda.library()
    mults = probe_mults(*probe)
    log(f"build: kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    log(f"SASS integer multiplies per primitive (sm_90a): {json.dumps(mults)}")

    # Phase 1: every kernel == its plain version, on the card.
    rng = np.random.default_rng(SEED)
    errs: dict[str, float] = {}
    timing = {}
    t0 = time.perf_counter()
    for name in OP_CHECK_SETS:
        ctx = BFVContext.build(get_bfv_params(name), device=dev, fusion="op")
        for kname, J, kern, plain, work in op_cases(ctx, rng, dev):
            compare(kname, kern(), plain(), errs)
            log(f"check {name} op {kname} J/blocks={J}: equal")
            if name == OP_SET and kname not in timing:
                timing[kname] = (kern, plain, work)
    timing32 = {}          # K3-K5 at n = 2^15, J = 1
    for name in OP32_CHECK_SETS:
        ctx = BFVContext.build(get_bfv_params(name), device=dev, fusion="op")
        for kname, J, kern, plain, work in op_cases(ctx, rng, dev):
            if kname not in OP32_KERNELS:
                continue
            compare(kname, kern(), plain(), errs)
            log(f"check {name} op (two 2^14 halves) {kname} J={J}: equal")
            if name == STAGE_SET and J == 1:
                timing32[kname] = (kern, plain, work)
    for kname, J, kern, plain, work in keystream_batch_cases(
            get_bfv_params(STAGE_SET), dev):
        bw = kern()
        compare(kname, bw, plain(), errs)
        for j, nonce in enumerate(sampling.encrypt_nonces(range(1, J + 1))):
            compare(kname, bw[j], salsa20.keystream_block_words(
                bw.shape[-1], nonce=int(nonce), device=dev), errs)
        log(f"check {STAGE_SET} {kname} J={J}: equal, each row equal to "
            f"K1's stream of its nonce")
        if J == BATCH_J:
            timing[kname] = (kern, plain, work)
    for name in STAGE_CHECK_SETS + ("32k_16q",):
        ctx = BFVContext.build(get_bfv_params(name), device=dev,
                               fusion="stage")
        for kname, J, kern, plain, work in stage_cases(ctx, rng, dev):
            if name == "32k_16q" and kname != "decrypt_tail":
                continue       # 32k_16q: the decrypt tail at r-1 = 15
            compare("ntt_transform" if kname in ("ntt_forward", "ntt_inverse")
                    else kname, kern(), plain(), errs)
            log(f"check {name} stage {kname} J={J}: equal")
            if name == STAGE_SET and J == 1 and kname != "decrypt_tail":
                timing[kname] = (kern, plain, work)
    for name in MULT_CHECK_SETS:
        ctx = BFVContext.build(get_bfv_params(name), device=dev)
        for kname, J, kern, plain, work in mult_cases(
                ctx, rng, dev, addneg=name != "32k_16q"):
            compare(kname, kern(), plain(), errs)
            log(f"check {name} {kname} J={J}: equal")
            if name == STAGE_SET and J == 1:
                timing[kname] = (kern, plain, work)
    timing30 = ntt30_checks(dev, rng, errs)
    torch.cuda.synchronize()
    log(f"checks: {time.perf_counter() - t0:.1f} s")

    # Phase 2: the reference's golden ciphertext, both schedules.
    fix = ROOT / "tests" / "fixtures"
    ct = np.stack([np.load(fix / "dec4k_c0.npy"), np.load(fix / "dec4k_c1.npy")])
    sk4 = np.load(fix / "dec4k_sk_ntt.npy")
    for fusion in ("op", "stage"):
        ctx4 = BFVContext.build(get_bfv_params("4k_3q"), device=dev,
                                fusion=fusion)
        m = ctx4.decrypt(sk4, ct).cpu().numpy()
        if not np.array_equal(m, np.arange(ctx4.params.n) % 10):
            raise AssertionError(f"golden dec4k ({fusion}) != i % 10")
    log("golden: dec4k decrypts to i % 10 on the card, op and stage")

    # Phase 3: the main paths through the public API, counts read per path.
    counts, paths = {}, {}
    for sched, name in (("op", OP_SET), ("stage", STAGE_SET)):
        p = get_bfv_params(name)
        ctx = (BFVContext.build(p, device=dev) if sched == "op" else
               BFVContext.build(p))       # the default device and fusion
        if ctx.fusion != sched or ctx.device != dev:
            raise AssertionError(f"{name}: built {ctx.fusion} on "
                                 f"{ctx.device}, expected {sched} on {dev}")
        msgs = np.random.default_rng(SEED).integers(0, p.t, (3, p.n))
        reset_counts()
        res = drive(ctx, msgs, dev)
        counts[sched] = read_counts()
        ref = drive(BFVContext.build(p, device="cpu", fusion=sched), msgs)
        check_path(f"{name} {sched}", res, msgs, ref)
        log(f"main path {name} ({sched}): 3 messages round-trip; "
            f"decrypt_batch agrees; keys and ciphertexts equal the CPU "
            f"plain path bit for bit")
        log(f"launch counts in the {name} {sched} run: "
            f"{json.dumps(counts[sched])}")
        missing = [k for k, (*_, s) in KERNELS.items()
                   if sched in s and counts[sched][k] < 1]
        if missing:
            raise AssertionError(f"kernels not launched on the {sched} "
                                 f"main path: {missing}")
        paths[sched] = (ctx, res, msgs)

    # Phase 4: the EvalMult main path, counts read per set.
    mult_paths = {}
    for name in MULT_SETS:
        p = get_bfv_params(name)
        ctx = BFVContext.build(p)             # the default device and fusion
        msgs = np.random.default_rng(SEED + 2).integers(0, p.t, (2, p.n))
        reset_counts()
        res = drive_mult(ctx, msgs, dev)
        cnt = read_counts()
        ref = (drive_mult(BFVContext.build(p, device="cpu"), msgs)
               if name == OP_SET else None)
        check_mult(p, res, msgs, dev, ref)
        log(f"EvalMult path {name} ({ctx.fusion}): mul at L = 3, mul + "
            f"relin and square + relin decrypt to the negacyclic products "
            f"mod t" + ("; keys and ciphertexts equal the CPU plain path "
                        "bit for bit" if ref else ""))
        log(f"launch counts in the {name} EvalMult run: {json.dumps(cnt)}")
        # the 32k_9q run is the whole path; at 16k_5q keygen and encrypt
        # take the op kernels, so only the EvalMult kernels are required
        need = [k for k, (*_, s) in KERNELS.items()
                if ("mult" in s if name == STAGE_SET else s == ("mult",))]
        missing = [k for k in need if cnt[k] < 1]
        if missing:
            raise AssertionError(f"kernels not launched on the {name} "
                                 f"EvalMult path: {missing}")
        if name == STAGE_SET:
            counts["mult"] = cnt
        mult_paths[name] = (ctx, res)

    # Phase 5: 32k_16q round trip; 16k_5q stage == op.
    p = get_bfv_params("32k_16q")
    ctx16 = BFVContext.build(p, device=dev)
    m16 = np.random.default_rng(SEED + 1).integers(0, p.t, (1, p.n))
    res16 = drive(ctx16, m16, dev)
    if not (np.array_equal(res16["outs"][0].cpu().numpy(), m16[0])
            and np.array_equal(res16["outb"].cpu().numpy(), m16)):
        raise AssertionError("32k_16q: decrypt(encrypt(m)) != m")
    log("32k_16q (stage): one message round-trips")
    ctx_op, res_op, msgs = paths["op"]
    ctx_st = BFVContext.build(ctx_op.params, device=dev, fusion="stage")
    res_st = drive(ctx_st, msgs, dev)
    check_path(f"{OP_SET} stage vs op", res_st, msgs, res_op)
    log(f"{OP_SET} under fusion='stage': keys, ciphertexts and plaintexts "
        f"equal the op schedule's")

    # Phase 6: batched encryption at full width, counts read per set.
    batch = {}
    for name in (STAGE_SET, OP_SET):
        p = get_bfv_params(name)
        ctx = BFVContext.build(p)             # the default device and fusion
        msgs = np.random.default_rng(SEED + 3).integers(0, p.t,
                                                        (BATCH_J, p.n))
        res = drive_batch(ctx, msgs, dev)
        if not torch.equal(res["cts"], res["each"]):
            raise AssertionError(f"{name}: encrypt_batch rows != encrypt of "
                                 f"each message and nonce")
        if not np.array_equal(res["outb"].cpu().numpy(), msgs):
            raise AssertionError(f"{name}: decrypt_batch(encrypt_batch(m)) "
                                 f"!= m")
        cnt = res["counts"]
        log(f"batch path {name} ({ctx.fusion}): encrypt_batch of {BATCH_J} "
            f"messages equals encrypt of each, row by row; decrypt_batch "
            f"round-trips them")
        log(f"launch counts in the {name} batch run: {json.dumps(cnt)}")
        missing = [k for k, (*_, s) in KERNELS.items()
                   if "batch" in s and cnt[k] < 1]
        if (missing or cnt["salsa20_keystream_batch"] != 1
                or cnt["encrypt_fused"] != 1):
            raise AssertionError(f"{name} batch path: kernels not launched "
                                 f"{missing}, or kernel 6 / K5 not once")
        if name == STAGE_SET:
            counts["batch"] = cnt
        batch[name] = (ctx, res)

    # Phase 7: the op schedule at 32k_9q (K3-K5 over two halves) == stage.
    ctx32, res32, msgs32 = paths["stage"]
    ctx_op32 = BFVContext.build(ctx32.params, fusion="op")
    if ctx_op32.fusion != "op" or ctx_op32.device != dev:
        raise AssertionError(f"{STAGE_SET}: fusion='op' built "
                             f"{ctx_op32.fusion} on {ctx_op32.device}")
    reset_counts()
    res_op32 = drive(ctx_op32, msgs32, dev)
    counts["op32"] = read_counts()
    check_path(f"{STAGE_SET} op vs stage", res_op32, msgs32, res32)
    log(f"main path {STAGE_SET} (op, two 2^14 halves): 3 messages "
        f"round-trip; keys, ciphertexts and plaintexts equal the stage "
        f"schedule's on the card")
    log(f"launch counts in the {STAGE_SET} op run: "
        f"{json.dumps(counts['op32'])}")
    missing = [k for k, (*_, s) in KERNELS.items()
               if "op32" in s and counts["op32"][k] < 1]
    if missing:
        raise AssertionError(f"kernels not launched on the {STAGE_SET} op "
                             f"path: {missing}")

    # Phase 8: the ciphertext ops at 32k_9q.
    budget = check_ctops(ctx32, res32, msgs32, dev)
    log(f"ciphertext ops {STAGE_SET}: add, sub, negate, add_plain, sub_plain "
        f"and mul_plain decrypt to their mod-t results, mod_switch_to_next "
        f"decrypts under next_context(); noise budget bits "
        f"{json.dumps(budget)}")

    # Phase 9: the CLI in-process on the default device.
    t0 = time.perf_counter()
    reset_counts()
    run_cli(["ntt-test", "--family", "30bit", "--n", "65536"], passes=1)
    torch.cuda.synchronize()
    counts["cli30"] = read_counts()
    log(f"launch counts in the ntt-test 30bit run: "
        f"{json.dumps(counts['cli30'])}")
    if counts["cli30"]["ntt30_transform"] < 2:
        raise AssertionError("ntt-test --family 30bit did not launch "
                             "kernel 22 forward and inverse")
    run_cli(["ntt-test", "--family", "60bit", "--n", "32768"], passes=1)
    run_cli(["decryption-test", "--fixtures", str(fix)], passes=1)
    run_cli(["keygen-test"], passes=1)
    run_cli(["--params", STAGE_SET, "demo", "--mul", "--time"], passes=2)
    with tempfile.TemporaryDirectory() as d:
        keys, ctf = str(Path(d) / "keys.npz"), str(Path(d) / "ct.npz")
        run_cli(["--params", OP_SET, "keys", "--out", keys])
        run_cli(["--params", OP_SET, "encrypt", "--keys", keys, "--out", ctf])
        out = run_cli(["--params", OP_SET, "decrypt", "--keys", keys, "--ct",
                       ctf])
        if f"plaintext head: {list(range(16))}" not in out:
            raise AssertionError("cli keys/encrypt/decrypt: not the ramp")
    log(f"cli: every command returned 0 and passed "
        f"({time.perf_counter() - t0:.1f} s)")

    # Phase 10: the Galois path.
    t0 = time.perf_counter()
    p32 = ctx32.params
    sk32, ct32 = res32["sk"], res32["cts"][0]
    gks32 = ctx32.galois_keygen(sk32, [3, 2 * p32.n - 1], nonce=1)
    for g, gk in gks32.items():
        got = ctx32.decrypt(sk32, ctx32.apply_galois(ct32, g, gk))
        if not torch.equal(got, tau_mod_t(msgs32[0], g, p32, dev)):
            raise AssertionError(f"{STAGE_SET}: apply_galois({g}) does not "
                                 f"decrypt to tau_g(m) mod t")
    log(f"galois {STAGE_SET}: galois_keygen for {sorted(gks32)}; "
        f"apply_galois decrypts to tau_g(m) mod t for each")
    reset_counts()
    dot = example.encrypted_dot_product(n=DOT_N, r=DOT_R, verbose=False)
    torch.cuda.synchronize()
    counts["galois"] = read_counts()
    check_dot(f"dot product n={DOT_N}", dot, dev)
    log(f"dot product n={DOT_N} r={DOT_R} t={dot['t']}: every slot holds "
        f"{dot['expected']}; noise budget {dot['budget']} bits")
    log(f"launch counts in the dot-product run: "
        f"{json.dumps(counts['galois'])}")
    missing = [k for k in GALOIS_NEED if counts["galois"][k] < 1]
    if missing:
        raise AssertionError(f"kernels not launched on the Galois path: "
                             f"{missing}")
    small = example.encrypted_dot_product(n=2048, verbose=False)
    small_cpu = example.encrypted_dot_product(n=2048, verbose=False,
                                              device="cpu")
    check_dot("dot product n=2048", small, dev)
    same = all(torch.equal(small[k].cpu(), small_cpu[k].cpu())
               for k in ("sk", "pk", "rlk", "ct", "slots"))
    same = same and all(torch.equal(a.cpu(), b.cpu()) for a, b in
                        zip(small["cts"], small_cpu["cts"]))
    same = same and sorted(small["gks"]) == sorted(small_cpu["gks"]) and all(
        torch.equal(small["gks"][g].cpu(), small_cpu["gks"][g].cpu())
        for g in small["gks"])
    if not same:
        raise AssertionError("dot product n=2048: keys/ciphertexts != the "
                             "CPU run")
    log(f"dot product n=2048: keys, Galois keys and ciphertexts equal the "
        f"CPU plain path bit for bit ({time.perf_counter() - t0:.1f} s)")

    # Phase 11: times on the card.
    ab32 = {"op": [], "stage": []}
    for sched, ctx, res in (("op", ctx_op32, res_op32),
                            ("stage", ctx32, res32), ("stage", ctx32, res32),
                            ("op", ctx_op32, res_op32)):
        ab32[sched].append(op_times(ctx, res, msgs32, 10))
    for sched, runs in ab32.items():
        log(f"op times {STAGE_SET} {sched} (ms, median of CUDA-event "
            f"timings; two turns of op, stage, stage, op): {json.dumps(runs)}")
    for name, (ctx, res) in batch.items():
        ms = median_ms(lambda: ctx.encrypt_batch(res["pk"], res["m"],
                                                 res["nonces"]), 10)
        log(f"encrypt_batch {name} {ctx.fusion} J={BATCH_J} (ms, median of "
            f"CUDA-event timings): per batch {ms}, per message "
            f"{ms / BATCH_J}")
    for name, (ctx, res) in mult_paths.items():
        log(f"EvalMult op times {name} {ctx.fusion} (ms, median of "
            f"CUDA-event timings): {json.dumps(mult_times(ctx, res, 10))}")
    ab = {"op": [], "stage": []}
    for sched, ctx, res in (("op", ctx_op, res_op), ("stage", ctx_st, res_st),
                            ("stage", ctx_st, res_st), ("op", ctx_op, res_op)):
        ab[sched].append(op_times(ctx, res, msgs, 10))
    for sched, runs in ab.items():
        log(f"op times {OP_SET} {sched} (ms, median of CUDA-event timings; "
            f"two turns of op, stage, stage, op): {json.dumps(runs)}")
    bounds, terms = {}, {}
    for kname, (kern, plain, work) in timing.items():
        terms[kname] = work.terms(mults, clock_hz)
        bounds[kname] = (kernel_ms(kern), kernel_ms(plain),
                         *work.bound(mults, clock_hz))
    log(f"bound terms (bytes moved, integer multiply instructions, and their "
        f"times at {HBM_BYTES_PER_S:.3g} B/s and {SMS} SMs x "
        f"{IMAD_PER_CLOCK}/clock): {json.dumps(terms)}")
    ctx, res = batch[STAGE_SET]
    u_b, e_d = sampling.encrypt_draws_compact_batch(ctx.params.n,
                                                    res["nonces"], device=dev)
    args = (u_b, res["pk"], e_d, res["m"], ctx.tables_full, ctx.tail_consts)
    timing32["encrypt_fused_J16"] = (
        lambda: fused_ops.encrypt_fused(*args),
        lambda: fused_ops.encrypt_fused_plain(*args),
        encrypt_work(ctx, u_b, res["pk"], e_d, res["m"], BATCH_J))
    op32 = {}
    for kname, (kern, plain, work) in timing32.items():
        bound_ms, bound_by = work.bound(mults, clock_hz)
        op32[kname] = {
            "ms": kernel_ms(kern), "plain_ms": kernel_ms(plain, reps=5),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "terms": work.terms(mults, clock_hz),
            "launches": (counts["batch"]["encrypt_fused"]
                         if kname == "encrypt_fused_J16"
                         else counts["op32"][kname])}
    log(f"op kernels at {STAGE_SET} (n = 2^15, two 2^14 halves; J = 1, K5 "
        f"also J = {BATCH_J}; launches on the op32 path, K5 J = 16 on the "
        f"batch path): {json.dumps(op32)}")
    ntt30_times = {}
    for (n, direction), (kern, plain, work) in timing30.items():
        bound_ms, bound_by = work.bound(mults, clock_hz)
        ntt30_times[f"n={n} {direction}"] = {
            "ms": kernel_ms(kern), "plain_ms": kernel_ms(plain, reps=5),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "terms": work.terms(mults, clock_hz)}
    log(f"kernel 22 at ({NTT30_BATCH}, 1, n) int32 (launches on the ntt-test "
        f"30bit path: {counts['cli30']['ntt30_transform']}): "
        f"{json.dumps(ntt30_times)}")
    k22 = ntt30_times["n=65536 fwd"]
    bounds["ntt30_transform"] = (k22["ms"], k22["plain_ms"], k22["bound_ms"],
                                 k22["bound_by"])
    more = {}
    for family, n in (("30bit", 65536), ("60bit", 32768)):
        q, psi, *_ = get_params(n, family)
        x = torch.from_numpy(np.random.default_rng(SEED).integers(
            0, q, (2, 1, n))).to(dev)
        tb = cli.ntt_tables(q, psi, n, family, dev)
        more[f"ntt-test polymul {family} n={n}"] = median_ms(
            lambda: cli.ntt_polymul(x, tb, q, family), 10)
    more[f"galois_keygen {STAGE_SET} one element"] = median_ms(
        lambda: ctx32.galois_keygen(sk32, [3], nonce=1), 10)
    more[f"apply_galois {STAGE_SET}"] = median_ms(
        lambda: ctx32.apply_galois(ct32, 3, gks32[3]), 10)
    more[f"dot product n={DOT_N} r={DOT_R}, set-up included"] = median_ms(
        lambda: example.encrypted_dot_product(n=DOT_N, r=DOT_R,
                                              verbose=False), 3, 1)
    log(f"CLI and Galois times (ms, median of CUDA-event timings around "
        f"one call): {json.dumps(more)}")
    inv = bounds.pop("ntt_inverse")
    log(f"kernel 7 inverse ({STAGE_SET}, x (r-1, n)): ms {inv[0]}, plain "
        f"ms {inv[1]}, bound ms {inv[2]} ({inv[3]})")
    bounds["ntt_transform"] = bounds.pop("ntt_forward")
    rows = []
    for kname, (_, source, replaces, scheds) in KERNELS.items():
        ms, plain_ms, bound_ms, bound_by = bounds[kname]
        rows.append({"name": kname, "route": "cuda", "source": source,
                     "replaces": replaces,
                     "launches": counts[scheds[0]][kname],
                     "max_abs_err": errs[kname], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": None})
    torch.cuda.synchronize()
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
