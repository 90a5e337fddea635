"""Smoke run of the PyTorch/CUDA port (ntt_cuda_tpu_torch) on one card.

    python3 chip_smoke.py

Builds the CUDA kernels from ntt_cuda_tpu_torch/csrc with nvcc (sm_90a, one
nvcc per source, all started together) and, beside them, a probe whose
SASS gives the integer multiply instructions of one Shoup butterfly and
one Montgomery product (for each kernel's bound), a probe library that
runs the cluster kernels' local stages two ways (LOCAL_AB_SRC: the stage
kernels' loop against tiled passes, the encrypt transform's two inverses
interleaved against in turn).  Then:

1. every kernel exactly (tolerance 0) against its plain PyTorch version on
   the card: the op kernels K1-K5 at 4k_3q and 16k_5q, K3-K5 also at
   32k_9q and 32k_16q (K3 and K4 two 2^14 halves beside stage-0 passes,
   K5 one cluster launch and its tail), K5 (J = 1 and 3) and kernel 18 at
   every cluster size B at 32k_9q and 16k_5q (the B whose two n/B buffers
   do not fit a block, 1 at 2^14 and 1, 2 at 2^15, refused), the stage
   kernels (7-10, 13) and the decrypt tail at 4k_3q, 16k_5q and 32k_9q
   (one cluster launch at 2^15), J = 1 and 3 where there is a batch axis,
   every stage row (7 both ways, 8-11, 12 both ways, 13's and 19/20's
   transforms, the coefficient shards' offset launches) also at cluster
   sizes B = 2, 4 and 8 at 32k_9q, K2 also at
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
7. the op schedule at 32k_9q (`fusion="op"`: K3 and K4 over two halves),
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
11. the RNS-sharded programs (ntt_cuda_tpu_torch/parallel/spmd.py and
   spmd_mult.py) at 32k_9q: kernels 16, 17 and 18, and the sharded
   EvalMult's kernel 20, 21a-c in band form and kernel 16's drop launch,
   against their plain versions at rank shapes (rows 0-3 and 6-9 of
   R = 3, rows 0-9 of R = 1; rows 6-9 hold q_last and m_sk, and
   bsk_to_q's zero pad row; power-of-two and odd prime t; 17 also at
   level 1 with a q = 1 pad row); then SpmdBFVContext at world size 1
   over NCCL through the public API (keygen, encrypt of three seeded
   messages, add, sub, decrypt, mod_switch_to_next, the level-1 decrypt),
   counts read as in 3, keys and live ciphertext rows equal to
   BFVContext.build(params)'s, every message round-tripped, one
   all-reduce per encrypt, decrypt and mod switch and none in keygen;
   SpmdMultContext on its keys and ciphertexts (relin_keygen, mul,
   relinearize, mul with rlk, decrypt3, galois_keygen([3]),
   apply_galois), counts read as in 3, the products decrypting to the
   negacyclic m1 m2 mod t and the rotation to tau_3(m1), keys and live
   rows equal to BFVContext.build(params)'s, mul's pad row 0, the
   collectives mul four all-gathers, relinearize and apply_galois one
   all-gather and one all-reduce, decrypt3 one all-reduce, the keygens
   none; and both in three processes on the one card over gloo (this
   script re-run as `--spmd-worker`; gloo must take CUDA tensors, or the
   run fails), every tensor equal to the world-size-1 run;
12. CUDA-event times: the 32k_9q ops and EvalMult ops, the 16k_5q EvalMult
   ops, the 16k_5q op-vs-stage and 32k_9q op-vs-stage A/Bs (in turns op,
   stage, stage, op), encrypt_batch at J = 16, galois_keygen (one
   element) and apply_galois at 32k_9q, ntt-test's product for both
   families, the whole dot product, and SPMD keygen / encrypt / decrypt /
   mul / relinearize / apply_galois at world size 1 beside BFVContext's
   (turns stage, op, spmd, spmd, op, stage), each around one call; every
   kernel and its plain version around a run of calls back to back,
   beside the kernel's bound (K3-K5 and K5 at J = 16 also at 32k_9q;
   kernel 22 at (16, 1, n), n = 2^15 and 2^16, both directions; kernels
   16-18, 20 and 21a-c's bands at 32k_9q's world-size-1 shapes, rl = 9;
   16's drop launch logged beside); the stage rows' device time
   (torch.profiler); the stage kernels' local stages, ntt_block.cuh's
   loop against its register-tiled passes, and kernels 7 and 8 at every
   cluster size B at n = 2^14 and 2^15 for P = 9, 18, 36 (device time and
   back-to-back CUDA events, each output held against its plain version);
   K5 at 16k_5q J = 1 and 32k_9q J = 1 and 16, and kernel 18 at 32k_9q, at
   every cluster size B, and the transform's two local inverses at those
   shapes interleaved (as the library runs them) and in turn, in turns.

13. kernels 12, 14 and 15 (the op-level entry points ntt_forward /
   ntt_inverse with mod_idx, encrypt_tail, decrypt_fused) against their
   plain versions: 12 over the standard and a permuted index (B = 2r + 1)
   at 4k_3q, 16k_5q and 32k_9q, both directions; 14 at 16k_5q and
   32k_9q; 15 at 32k_9q, 32k_16q and on the golden ciphertext; then the
   ops path at 32k_9q on the stage path's keys (counts read as in 3):
   encrypt of its three messages through kernels 12, 8 and 14 equal to
   BFVContext.encrypt's ciphertexts, decrypt through 12 and 15
   round-tripping, 15 equal to the decrypt's back half (8 + K2);
14. the coefficient-sharded transform (parallel/coef_kernels.py) at
   32k_9q, C = 2 and 4 shards driven in one process (counts read as in
   3), equal to kernels 7 and 8 on the whole polynomial; and the 2-D
   program (parallel/spmd2d.py: keygen, encrypt of three messages,
   decrypt) at world size 1 over NCCL, mesh (1, 1), and over gloo on the
   one card at meshes (1, 2) and (3, 2) (this script re-run as
   `--spmd2d-worker`), keys and live rows equal to BFVContext.build(
   params)'s, every message round-tripped, the collectives JAX's budget
   (keygen 3 log2 C ppermutes, encrypt and decrypt 2 log2 C and one
   all-reduce), every gloo tensor equal to world size 1's;
15. times: 12, 14, 15 and the cross-stage glue beside their bounds and
   plain versions; 15 beside kernel 8 + K2 and, forward included, 7 + 15
   beside K3 + K2; 2-D keygen / encrypt / decrypt at world size 1 in
   turns beside SpmdBFVContext and BFVContext.

Prints the card's name and power limit, one JSON line of per-kernel
results, and last `{"ok": true, "device": {...}}`.  Any failure raises,
so the exit code is not 0 and no result line is printed.  Imports no jax.
"""

from __future__ import annotations

import contextlib
import ctypes
import io
import json
import re
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from ntt_cuda_tpu_torch import BFVContext, cli, cuda, get_bfv_params  # noqa: E402
from ntt_cuda_tpu_torch.examples import (  # noqa: E402
    encrypted_dot_product as example)
from ntt_cuda_tpu_torch.ops import (behz, behz_kernels,  # noqa: E402
                                    bfv_tail, fused_ops, ntt, ntt30,
                                    ntt_stage, poly, salsa20, sampling)
from ntt_cuda_tpu_torch.params import BFVParams, get_params  # noqa: E402
from ntt_cuda_tpu_torch.parallel import (mesh as pmesh,  # noqa: E402
                                         coef_kernels, multihost, sharded,
                                         spmd, spmd2d, spmd_mult)
from ntt_cuda_tpu_torch.utils import primegen  # noqa: E402
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
SPMD_SET = "32k_9q"          # the RNS-sharded program's path
SPMD_R = 3                   # its ranks in the one-card gloo run, rl = 3
# rank rows of kernels 16-18's checks: R = 3's rank 0 (no dropped row) and
# rank 2 (the dropped row), and R = 1's rows (also the timed shape)
SPMD_BANDS = ((0, 3), (6, 9), (0, 9))
SPMD_MSGS = 3
SPMD_GALOIS = 3              # the sharded EvalMult path's Galois element
# where drive_spmd / drive_spmd_mult's tensors are sharded (else axis 1;
# the plaintexts, "dec*", are replicated)
SPMD_SHARD_DIM = {"sk": 0, "rlk": 2, "gk": 2}
OPS_SET = "32k_9q"           # the op-level entry points' path (12, 14, 15)
OPS_MSGS = 3
IDX_CHECK_SETS = ("4k_3q", "16k_5q", "32k_9q")   # kernel 12
TAIL_CHECK_SETS = ("16k_5q", "32k_9q")           # kernel 14
DEC_FUSED_SETS = ("32k_9q", "32k_16q")           # kernel 15
COEF_SET, COEF_CS = "32k_9q", (2, 4)   # the coefficient-sharded transform
SPMD2D_MESHES = ((1, 2), (3, 2))       # (rns, coef) over gloo on one card
# the stage kernels' cluster sizes (csrc/ntt_stage.cu): timed at n = 2^14
# and 2^15 (tables of 16k_9q and 32k_9q) for P = 9 (32k_9q, J = 1), 18
# (encrypt's and keygen's 2r launches) and 36 (J = 4) polynomials at every
# B a launch takes, and every stage row held against its plain version at
# B = 2, 4, 8 at 32k_9q beside the rule's B of the main path
CLUSTER_SETS = {14: "16k_9q", 15: "32k_9q"}
CLUSTER_PS = (9, 18, 36)
CLUSTER_BS = (1, 2, 4, 8)
CLUSTER_CHECK_BS = (2, 4, 8)
# K5's transform and kernel 18 (csrc/fused_ops.cu, two n/B buffers a
# block): held against their plain versions at every B at these sets, and
# timed at every B a launch takes at these (label, set, J) shapes, J = 0
# for kernel 18 over all r moduli (the world-size-1 rank's shape)
ENC_CHECK_SETS = ("32k_9q", "16k_5q")
ENC_TIME_CASES = (("K5", "16k_5q", 1), ("K5", "32k_9q", 1),
                  ("K5", "32k_9q", BATCH_J), ("18", "32k_9q", 0))
ENC_ENTRIES = ("ntt_encrypt_transform_cluster", "ntt_encrypt_front_cluster")
# the rows that run the stage kernels, as timed (12 at (19, n), 13 with its
# tail launch, 19 its three launches, 20 at rl = 9)
STAGE_ROWS = ("ntt_forward", "ntt_inverse", "ntt_inverse_mul",
              "ntt_forward_ternary", "ntt_forward_addneg_gauss",
              "ntt_forward_addneg", "ntt_transform_idx",
              "encrypt_fused_stage", "keyswitch_fused", "keyswitch_front")
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
SMS, IMAD_PER_CLOCK = 132, 64  # 32-bit integer multiplies per SM per clock

# name -> (wrappers, CUDA source, the TPU kernel it replaces, the main
# paths that run it; its `launches` are the first path's: the EvalMult
# path's wherever it runs the kernel)
KERNELS = {
    "salsa20_keystream": ((salsa20.keystream_block_words,),
                          "ntt_cuda_tpu_torch/csrc/salsa20.cu",
                          "ntt_cuda_tpu/ops/salsa20.py:174",
                          ("mult", "op", "stage", "op32", "spmd",
                           "spmd_mult", "spmd2d")),
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
                     "ntt_cuda_tpu/ops/fused_ops.py:213",
                     ("op", "op32", "spmd", "spmd_mult")),
    "keygen_fused": ((fused_ops.keygen_fused,),
                     "ntt_cuda_tpu_torch/csrc/fused_ops.cu",
                     "ntt_cuda_tpu/ops/fused_ops.py:137",
                     ("op", "op32", "spmd")),
    "encrypt_fused": ((fused_ops.encrypt_fused,),
                      "ntt_cuda_tpu_torch/csrc/fused_ops.cu",
                      "ntt_cuda_tpu/ops/fused_ops.py:466",
                      ("op", "batch", "op32")),
    # kernel 7, both directions (one TPU kernel with an `inverse` flag);
    # its times below are the forward's, the direction the main path runs
    # (also its shard-offset launch, coef_kernels.local_forward, on the
    # 2-D program's path)
    "ntt_transform": ((ntt_stage.ntt_forward, ntt_stage.ntt_inverse,
                       coef_kernels.local_forward),
                      "ntt_cuda_tpu_torch/csrc/ntt_stage.cu",
                      "ntt_cuda_tpu/ops/ntt_pallas.py:558",
                      ("mult", "stage", "spmd_mult", "spmd2d", "coef")),
    "ntt_inverse_mul": ((ntt_stage.ntt_inverse_mul,
                         coef_kernels.local_inverse_mul),
                        "ntt_cuda_tpu_torch/csrc/ntt_stage.cu",
                        "ntt_cuda_tpu/ops/ntt_pallas.py:685",
                        ("mult", "stage", "spmd_mult", "spmd2d", "coef")),
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
                           "ntt_cuda_tpu/ops/ntt_pallas.py:868",
                           ("mult", "spmd_mult")),
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
    # the RNS-sharded program's kernels (parallel/spmd.py): 18, 16, 17
    "encrypt_front": ((fused_ops.encrypt_front,),
                      "ntt_cuda_tpu_torch/csrc/fused_ops.cu",
                      "ntt_cuda_tpu/ops/fused_ops.py:301", ("spmd",)),
    # 16 also as the sharded key switch's modulus drop (no e, no message)
    "encrypt_tail_padded": ((bfv_tail.encrypt_tail_padded,
                             bfv_tail.drop_last_padded),
                            "ntt_cuda_tpu_torch/csrc/fused_ops.cu",
                            "ntt_cuda_tpu/ops/bfv_tail.py:760",
                            ("spmd", "spmd_mult", "spmd2d")),
    "decrypt_tail_partial": ((bfv_tail.decrypt_tail_partial,),
                             "ntt_cuda_tpu_torch/csrc/decrypt_tail.cu",
                             "ntt_cuda_tpu/ops/bfv_tail.py:886",
                             ("spmd", "spmd_mult", "spmd2d")),
    # the sharded EvalMult's kernels (parallel/spmd_mult.py): 20 (kernel
    # 19's two transform launches over a rank's rows) and 21a-c in band form
    "keyswitch_front": ((fused_ops.keyswitch_front,),
                        "ntt_cuda_tpu_torch/csrc/ntt_stage.cu",
                        "ntt_cuda_tpu/ops/fused_ops.py:766", ("spmd_mult",)),
    "behz_rns_to_bsk_rows": ((behz_kernels.rns_to_bsk_rows,),
                             "ntt_cuda_tpu_torch/csrc/behz.cu",
                             "ntt_cuda_tpu/ops/behz_pallas.py:431",
                             ("spmd_mult",)),
    "behz_fast_floor_rows": ((behz_kernels.fast_floor_rows,),
                             "ntt_cuda_tpu_torch/csrc/behz.cu",
                             "ntt_cuda_tpu/ops/behz_pallas.py:447",
                             ("spmd_mult",)),
    "behz_bsk_to_q_rows": ((behz_kernels.bsk_to_q_rows,),
                           "ntt_cuda_tpu_torch/csrc/behz.cu",
                           "ntt_cuda_tpu/ops/behz_pallas.py:464",
                           ("spmd_mult",)),
    # the op-level entry points (the ops path): 12 (ntt_forward /
    # ntt_inverse with mod_idx), 14 (encrypt_tail), 15 (decrypt_fused)
    "ntt_transform_idx": ((ntt_stage.ntt_transform_idx,),
                          "ntt_cuda_tpu_torch/csrc/ntt_stage.cu",
                          "ntt_cuda_tpu/ops/ntt_pallas.py:496", ("ops",)),
    "encrypt_tail": ((bfv_tail.encrypt_tail,),
                     "ntt_cuda_tpu_torch/csrc/fused_ops.cu",
                     "ntt_cuda_tpu/ops/bfv_tail.py:144", ("ops",)),
    "decrypt_fused": ((bfv_tail.decrypt_fused,),
                      "ntt_cuda_tpu_torch/csrc/ntt_stage.cu",
                      "ntt_cuda_tpu/ops/bfv_tail.py:507", ("ops",)),
    # glue of the coefficient-sharded transform, not a TPU kernel: the
    # cross-shard butterfly, XLA in the JAX package (parallel/sharded.py
    # _cross_forward_stage); its launches are the one-process coef path's
    "coef_cross_stage": ((coef_kernels.cross_stage,),
                         "ntt_cuda_tpu_torch/csrc/ntt_stage.cu",
                         "ntt_cuda_tpu/parallel/sharded.py:102", ("coef",)),
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


# The local stages of the cluster kernels two ways, on P 2^c blocks of
# 2^(logn - c) points each (block b: piece b % 2^c of polynomial b >> c,
# the cluster schedule's tw_mul = 2^c + piece over the full tables).
# k_ab_local: V = 0 ntt_block.cuh's loop (one block barrier and one
# shared-memory round trip a stage), V = 2 or 3 its register-tiled passes
# of V stages.  k_ab_pair: the encrypt transform's local inverse stages of
# its two products (fused_ops.cu's phase B), two buffers a block, T = 0
# interleaved in one tiled pass (each twiddle load serving both, as the
# library does), T = 1 one tiled inverse after the other.
LOCAL_AB_SRC = r"""
#include "ntt_cluster.cuh"
template <int V>
__global__ void __launch_bounds__(1024)
    k_ab_local(const u64* x, u64* out, Twiddles tw, int logn, int c, int r,
               int inverse) {
  extern __shared__ u64 s[];
  const int logb = logn - c, nb = 1 << logb, b = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int m = (1 << c) + (b & ((1 << c) - 1));
  const int mi = (b >> c) % r;
  const ModConsts k = load_consts(tw.consts, mi);
  const Twiddles t = twiddles_at(tw, mi, 1 << logn);
  for (int i = tid; i < nb; i += nt) s[i] = x[(size_t)b * nb + i];
  if constexpr (V == 0) {
    if (inverse) ntt_inv_block(s, logb, t, k.q, tid, nt, m);
    else ntt_fwd_block(s, logb, t, k.q, tid, nt, m);
  } else {
    if (inverse) ntt_inv_tiled<V>(s, logb, t, k.q, tid, nt, m);
    else ntt_fwd_tiled<V>(s, logb, t, k.q, tid, nt, m);
  }
  for (int i = tid; i < nb; i += nt) out[(size_t)b * nb + i] = s[i];
}
extern "C" int ab_local(int v, int inverse, const void* x, void* out,
                        const void* psi, const void* psi_sh, const void* ipsi,
                        const void* ipsi_sh, const void* consts, int P, int r,
                        int logn, int c, void* stream) {
  const int nb = 1 << (logn - c);
  void (*kern)(const u64*, u64*, Twiddles, int, int, int, int) =
      v == 0 ? k_ab_local<0> : v == 2 ? k_ab_local<2> : k_ab_local<3>;
  const int threads = v == 0 ? ntt_threads(nb)
                      : v == 2 ? tiled_threads<2>(nb) : tiled_threads<3>(nb);
  const cudaError_t e = smem_limit_once((const void*)kern);
  if (e != cudaSuccess) return (int)e;
  kern<<<P << c, threads, nb * sizeof(u64), (cudaStream_t)stream>>>(
      (const u64*)x, (u64*)out, make_tw(psi, psi_sh, ipsi, ipsi_sh, consts),
      logn, c, r, inverse);
  return (int)cudaGetLastError();
}
template <int T>
__global__ void __launch_bounds__(1024)
    k_ab_pair(const u64* x, const u64* y, u64* ox, u64* oy, Twiddles tw,
              int logn, int c, int r) {
  extern __shared__ u64 s[];
  const int logb = logn - c, nb = 1 << logb, b = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int m = (1 << c) + (b & ((1 << c) - 1));
  const int mi = (b >> c) % r;
  const ModConsts k = load_consts(tw.consts, mi);
  const Twiddles t = twiddles_at(tw, mi, 1 << logn);
  const size_t off = (size_t)b * nb;
  u64* s1 = s + nb;
  for (int i = tid; i < nb; i += nt) {
    s[i] = x[off + i];
    s1[i] = y[off + i];
  }
  if constexpr (T == 0) {
    u64* const both[2] = {s, s1};
    ntt_inv_tiled<STAGE_TILE, 2>(both, logb, t, k.q, tid, nt, m);
  } else {
    ntt_inv_tiled<STAGE_TILE>(s, logb, t, k.q, tid, nt, m);
    ntt_inv_tiled<STAGE_TILE>(s1, logb, t, k.q, tid, nt, m);
  }
  for (int i = tid; i < nb; i += nt) {
    ox[off + i] = s[i];
    oy[off + i] = s1[i];
  }
}
extern "C" int ab_pair(int turns, const void* x, const void* y, void* ox,
                       void* oy, const void* psi, const void* psi_sh,
                       const void* ipsi, const void* ipsi_sh,
                       const void* consts, int P, int r, int logn, int c,
                       void* stream) {
  const int nb = 1 << (logn - c);
  void (*kern)(const u64*, const u64*, u64*, u64*, Twiddles, int, int, int) =
      turns ? k_ab_pair<1> : k_ab_pair<0>;
  if (2 * nb > (1 << LOG_BLOCK_MAX)) return (int)cudaErrorInvalidValue;
  const cudaError_t e = smem_limit_once((const void*)kern);
  if (e != cudaSuccess) return (int)e;
  kern<<<P << c, tiled_threads<STAGE_TILE>(nb), 2 * nb * sizeof(u64),
         (cudaStream_t)stream>>>(
      (const u64*)x, (const u64*)y, (u64*)ox, (u64*)oy,
      make_tw(psi, psi_sh, ipsi, ipsi_sh, consts), logn, c, r);
  return (int)cudaGetLastError();
}
"""
LOCAL_AB_VARIANTS = {"loop": 0, "tiled2": 2, "tiled3": 3}
PAIR_ORDERS = {"interleaved": 0, "in_turn": 1}


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


def start_local_ab() -> tuple[subprocess.Popen, Path]:
    out = ROOT / "build" / "local_ab"
    out.mkdir(parents=True, exist_ok=True)
    (out / "local_ab.cu").write_text(LOCAL_AB_SRC)
    lib = out / "liblocal_ab.so"
    cmd = [cuda.find_nvcc(), *cuda.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
           "-I", str(cuda.CSRC), "-o", str(lib), str(out / "local_ab.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), lib


def start_ptxas_report() -> list[subprocess.Popen]:
    """ntt_stage.cu and fused_ops.cu compiled once more with `-Xptxas -v`
    (registers, spills and stack of each kernel), beside the library's
    build."""
    out = ROOT / "build" / "ptxas"
    out.mkdir(parents=True, exist_ok=True)
    return [subprocess.Popen(
        [cuda.find_nvcc(), *cuda.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
         str(out / f"{src}.o"), str(cuda.CSRC / f"{src}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src in ("ntt_stage", "fused_ops")]


def built(proc: subprocess.Popen, what: str) -> str:
    """The output of a finished nvcc; raises if it failed."""
    out = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc ({what}) failed:\n{out}")
    return out


def ptxas_lines(out: str, kernels: str) -> dict[str, str]:
    """The ptxas lines (registers; stack and spills) of each kernel whose
    mangled name matches `kernels`, from a `-Xptxas -v` build's output."""
    res, fn = {}, None
    for line in out.splitlines():
        m = re.search(r"(?:entry function '|properties for )(\w+)", line)
        if m:
            fn = m.group(1) if re.search(kernels, m.group(1)) else None
        elif fn and ("spill" in line or "registers" in line):
            res[fn] = (res.get(fn, "") + " " + line.split(":")[-1].strip()
                       ).strip()
    return res


def ptxas_report(procs: list[subprocess.Popen]) -> dict[str, str]:
    res = {}
    for proc in procs:
        res.update(ptxas_lines(built(proc, "ptxas report"),
                               "k_stage_|k_encrypt_cluster"))
    return res


def device_us(fn, reps: int = 20) -> float:
    """Device time of one call in us: torch.profiler's intervals of the
    port's kernels (k_*) over `reps` calls, summed, over reps."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    iv = [e.time_range.end - e.time_range.start for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and e.name.removeprefix("void ").startswith("k_")]
    if not iv:
        raise RuntimeError("torch.profiler saw no kernel of the port on the "
                           "device")
    return sum(iv) / reps


def local_ab(path: Path, dev, rng) -> dict:
    """The stage kernels' local stages, the loop against the tiled
    passes, at every (n, B) of the per-B timings, P = 9: device us per
    launch of each variant (torch.profiler), its three outputs equal."""
    fn = ctypes.CDLL(str(path)).ab_local
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 7
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    res = {}
    for logn, name in CLUSTER_SETS.items():
        p = get_bfv_params(name)
        tb = ntt.tables_for(p, device=dev)
        x = rand_res(rng, p.q, p.n, (), dev)
        for c in range(4):
            if not 2 <= p.n >> c <= cuda.BLOCK_MAX_N:
                continue
            for inverse in (0, 1):
                outs, row = {}, {}
                for label, v in LOCAL_AB_VARIANTS.items():
                    o = torch.empty_like(x)

                    def call(v=v, o=o):
                        rc = fn(v, inverse, x.data_ptr(), o.data_ptr(),
                                *tb.kernel_args(), p.r, p.r, logn, c,
                                torch.cuda.current_stream().cuda_stream)
                        if rc != 0:
                            raise RuntimeError(f"ab_local: CUDA error {rc}")
                    call()
                    outs[label] = o.clone()
                    row[label] = device_us(call)
                if not all(torch.equal(o, outs["loop"])
                           for o in outs.values()):
                    raise AssertionError(f"local-stage A/B 2^{logn} "
                                         f"B={1 << c}: the variants' "
                                         f"integers differ")
                res[f"2^{logn} B={1 << c} {'inv' if inverse else 'fwd'}"] = row
    return res


def pair_ab(path: Path, dev, rng) -> dict:
    """The encrypt transform's two local inverses, interleaved (as
    fused_ops.cu runs them) against in turn, at the ENC_TIME_CASES shapes
    (J r polynomials of 2^logn points) and every B the encrypt launchers
    take: device us per launch (torch.profiler) in turns interleaved, in
    turn, in turn, interleaved, both outputs equal to the one-array tiled
    inverse of each input."""
    lib = ctypes.CDLL(str(path))
    lib.ab_pair.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 9
                            + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.ab_pair.restype = ctypes.c_int
    lib.ab_local.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 7
                             + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.ab_local.restype = ctypes.c_int
    res = {}
    for label, name, J in ENC_TIME_CASES:
        p = get_bfv_params(name)
        tb = ntt.tables_for(p, device=dev)
        lead = (J,) if J else ()
        x, y = (rand_res(rng, p.q, p.n, lead, dev) for _ in range(2))
        P = max(J, 1) * p.r
        stream = torch.cuda.current_stream().cuda_stream
        for c in range(4):
            if not enc_fits(1 << c, p.n):
                continue
            ref = []
            for a in (x, y):
                o = torch.empty_like(a)
                if lib.ab_local(3, 1, a.data_ptr(), o.data_ptr(),
                                *tb.kernel_args(), P, p.r, p.logn, c,
                                stream) != 0:
                    raise RuntimeError("ab_local: CUDA error")
                ref.append(o)
            ox, oy = torch.empty_like(x), torch.empty_like(y)
            calls = {}
            for which, t in PAIR_ORDERS.items():
                def call(t=t):
                    rc = lib.ab_pair(t, x.data_ptr(), y.data_ptr(),
                                     ox.data_ptr(), oy.data_ptr(),
                                     *tb.kernel_args(), P, p.r, p.logn, c,
                                     torch.cuda.current_stream().cuda_stream)
                    if rc != 0:
                        raise RuntimeError(f"ab_pair: CUDA error {rc}")
                call()
                if not (torch.equal(ox, ref[0]) and torch.equal(oy, ref[1])):
                    raise AssertionError(f"inverse-pair A/B {name} J={J} "
                                         f"B={1 << c} {which}: not the "
                                         f"one-array inverse's integers")
                calls[which] = call
            row = {which: [] for which in PAIR_ORDERS}
            for which in ("interleaved", "in_turn", "in_turn", "interleaved"):
                row[which].append(device_us(calls[which]))
            res[f"{label} {name}" + (f" J={J}" if J else "")
                + f" B={1 << c}"] = row
    return res


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


def cluster_checks(dev, rng, errs: dict) -> None:
    """Every stage row through the launchers at cluster size B = 2, 4, 8
    at 32k_9q (J = 1), against its plain version: kernel 7 both ways, 8, 9,
    10, 11, 12 (a permuted mod_idx, both ways), 13's transform (PRO_MONT
    with +e), 19's and 20's two launches (PRO_DIGIT, PRO_KSACC) and the
    coefficient shards' offset launches (C = 2 and 4, forward and inverse
    with y)."""
    p = get_bfv_params(STAGE_SET)
    tb = ntt.tables_for(p, device=dev)
    ms, n, r = tb.ms, p.n, p.r
    x, e, y = (rand_res(rng, p.q, n, (), dev) for _ in range(3))
    d = torch.from_numpy(rng.integers(-19, 17, (2, n))
                         .astype(np.int32)).to(dev)
    t = d[0].clamp(-1, 2).contiguous()
    pk = rand_res(rng, p.q, n, (2,), dev)
    k = r - 1
    c2 = rand_res(rng, p.q[:-1], n, (), dev)
    ksk = rand_res(rng, p.q, n, (2, k), dev)
    idx = torch.from_numpy(rng.permutation(np.arange(2 * r + 1) % r)
                           .astype(np.int32))
    xi = torch.from_numpy(np.stack([rng.integers(0, p.q[i], n)
                                    for i in idx.tolist()])).to(dev)
    idx_d = idx.to(dev)
    plain = {
        "fwd": ntt_stage.ntt_forward_plain(x, tb),
        "inv": ntt_stage.ntt_inverse_plain(x, tb),
        "inv_mul": ntt_stage.ntt_inverse_mul_plain(x, y, tb),
        "ternary": ntt_stage.ntt_forward_ternary_plain(t, tb),
        "gauss": ntt_stage.ntt_forward_addneg_gauss_plain(x, d[1], tb),
        "addneg": ntt_stage.ntt_forward_addneg_plain(x, e, tb),
        "idx_fwd": ntt_stage.ntt_transform_idx_plain(xi, tb, idx),
        "idx_inv": ntt_stage.ntt_transform_idx_plain(xi, tb, idx, True),
        "enc": poly.poly_add(ntt.ntt_inverse(ntt.dyadic_mul(y[None], pk, ms),
                                             tb),
                             sampling.small_res(d, ms.q), ms),
        "front": fused_ops.keyswitch_front_plain(c2, ksk, tb),
    }
    empty = torch.empty_like
    for B in CLUSTER_CHECK_BS:
        o = {key: empty(v) for key, v in plain.items()}
        fl, il = ntt_stage.forward_launch, ntt_stage.inverse_launch
        fl(dev, x, None, o["fwd"], tb, cuda.PRO_COPY, cluster=B)
        il(dev, x, None, None, o["inv"], tb, cluster=B)
        il(dev, x, y, None, o["inv_mul"], tb, cluster=B)
        fl(dev, None, t, o["ternary"], tb, cuda.PRO_TERNARY, cluster=B)
        fl(dev, x, d[1].contiguous(), o["gauss"], tb, cuda.PRO_ADDNEG_GAUSS,
           cluster=B)
        fl(dev, x, None, o["addneg"], tb, cuda.PRO_ADDNEG, y=e, cluster=B)
        fl(dev, xi, None, o["idx_fwd"], tb, cuda.PRO_COPY, mod_idx=idx_d,
           cluster=B)
        il(dev, xi, None, None, o["idx_inv"], tb, mod_idx=idx_d, cluster=B)
        il(dev, pk, y, d, o["enc"], tb, cluster=B)
        dhat = torch.empty((k, r, n), dtype=torch.int64, device=dev)
        fl(dev, c2, None, dhat, tb, cuda.PRO_DIGIT, nu=ms.nu, cluster=B)
        cuda.launch("ntt_stage_inverse_cluster", dev, dhat.data_ptr(),
                    ksk.data_ptr(), None, o["front"].data_ptr(),
                    *tb.kernel_args(), cuda.PRO_KSACC, k, 2 * r, r, p.logn,
                    None, 0, 0, B)
        for key, names in (("fwd", ("ntt_transform",)),
                           ("inv", ("ntt_transform",)),
                           ("inv_mul", ("ntt_inverse_mul",)),
                           ("ternary", ("ntt_forward_ternary",)),
                           ("gauss", ("ntt_forward_addneg_gauss",)),
                           ("addneg", ("ntt_forward_addneg",)),
                           ("idx_fwd", ("ntt_transform_idx",)),
                           ("idx_inv", ("ntt_transform_idx",)),
                           ("enc", ("encrypt_fused_stage",)),
                           ("front", ("keyswitch_fused", "keyswitch_front"))):
            for name in names:
                compare(name, o[key], plain[key], errs)
        for C in COEF_CS:
            logc, S = C.bit_length() - 1, n // C
            for c in range(C):
                xs = x[:, c * S:(c + 1) * S].contiguous()
                ys = y[:, c * S:(c + 1) * S].contiguous()
                of, oi = empty(xs), empty(xs)
                fl(dev, xs, None, of, tb, cuda.PRO_COPY, logc=logc, shard=c,
                   cluster=B)
                il(dev, xs, ys, None, oi, tb, logc=logc, shard=c, cluster=B)
                compare("ntt_transform", of,
                        sharded.local_forward_stages(xs, tb, C, c), errs)
                compare("ntt_inverse_mul", oi,
                        coef_kernels.local_inverse_mul_plain(xs, ys, tb, C, c),
                        errs)
        log(f"check {STAGE_SET} stage rows at cluster size B={B} (7 both "
            f"ways, 8, 9, 10, 11, 12 both ways, 13's and 19/20's "
            f"transforms, the shard offsets at C = {COEF_CS}): equal")


def cluster_times(dev, rng, errs: dict) -> dict:
    """Kernel 7 (forward) and 8 (inverse with y) at n = 2^14 and 2^15 for
    P = 9, 18, 36 at every cluster size B a launch takes: device us per
    launch (torch.profiler) and ms per call back to back (CUDA events),
    and the rule's B; each output held against its plain version."""
    res = {}
    for logn, name in CLUSTER_SETS.items():
        p = get_bfv_params(name)
        tb = ntt.tables_for(p, device=dev)
        y = rand_res(rng, p.q, p.n, (), dev)
        for P in CLUSTER_PS:
            x = rand_res(rng, p.q, p.n, (P // p.r,), dev)
            ref_f = ntt_stage.ntt_forward_plain(x, tb)
            ref_i = ntt_stage.ntt_inverse_mul_plain(x, y, tb)
            out = torch.empty_like(x)
            for B in CLUSTER_BS:
                if not 2 <= p.n // B <= cuda.BLOCK_MAX_N:
                    continue
                fwd = lambda B=B: ntt_stage.forward_launch(
                    dev, x, None, out, tb, cuda.PRO_COPY, cluster=B)
                inv = lambda B=B: ntt_stage.inverse_launch(
                    dev, x, y, None, out, tb, cluster=B)
                fwd()
                compare("ntt_transform", out, ref_f, errs)
                inv()
                compare("ntt_inverse_mul", out, ref_i, errs)
                res[f"2^{logn} P={P} B={B}"] = {
                    "rule": B == ntt_stage.cluster_size(p.n),
                    "fwd_us": device_us(fwd), "inv_mul_us": device_us(inv),
                    "fwd_ms": kernel_ms(fwd), "inv_mul_ms": kernel_ms(inv)}
    return res


def enc_fits(B: int, n: int) -> bool:
    """Whether the encrypt launchers take cluster size B at n points: two
    n/B u64 buffers in at most 2^14 u64 (128 KB) a block."""
    return 2 <= n // B and 2 * n // B <= cuda.BLOCK_MAX_N


def enc_inputs(ctx: BFVContext, rng, J: int, dev):
    """K5's inputs for J messages at ctx's set: a seeded (2, r, n) pk, the
    compact draws of nonces 1..J and seeded messages."""
    p = ctx.params
    pk = rand_res(rng, p.q, p.n, (2,), dev)
    u_b, e_d = sampling.encrypt_draws_compact_batch(p.n, range(1, J + 1),
                                                    device=dev)
    m = torch.from_numpy(rng.integers(0, p.t, (J, p.n))).to(dev)
    return pk, u_b, e_d, m


def enc_calls(ctx: BFVContext, inputs, B: int):
    """K5 over the inputs' J messages and kernel 18 on message 0 at cluster
    size B: (kernel, wrapper call, plain call) each."""
    pk, u_b, e_d, m = inputs
    tf, tc = ctx.tables_full, ctx.tail_consts
    u0 = u_b[0]
    return (("encrypt_fused",
             lambda: fused_ops.encrypt_fused(u_b, pk, e_d, m, tf, tc,
                                             cluster=B),
             lambda: fused_ops.encrypt_fused_plain(u_b, pk, e_d, m, tf, tc)),
            ("encrypt_front",
             lambda: fused_ops.encrypt_front(u0, pk, tf, cluster=B),
             lambda: fused_ops.encrypt_front_plain(u0, pk, tf)))


def enc_transform(ctx: BFVContext, inputs, B: int):
    """K5's transform alone at cluster size B through the library's
    launcher: the (J, 2, r, n) scratch."""
    p, tf = ctx.params, ctx.tables_full
    pk, u_b, e_d, _ = inputs
    out = torch.empty((u_b.shape[0], 2, p.r, p.n), dtype=torch.int64,
                      device=pk.device)
    raw_launch(cuda.library(), ENC_ENTRIES[0], u_b.data_ptr(),
               pk.data_ptr(), e_d.data_ptr(), out.data_ptr(),
               *tf.kernel_args(), u_b.shape[0], p.r, p.logn, B)
    return out


def encrypt_cluster_checks(dev, rng, errs: dict) -> None:
    """K5 (J = 1 and 3: its transform's scratch, and the wrapper's
    ciphertexts) and kernel 18 at cluster sizes B = 1, 2, 4, 8 at 32k_9q
    and 16k_5q against their plain versions; a B whose two n/B buffers do
    not fit a block must be refused (the wrapper raises)."""
    for name in ENC_CHECK_SETS:
        ctx = BFVContext.build(get_bfv_params(name), device=dev, fusion="op")
        n = ctx.params.n
        for J in (1, 3):
            inputs = enc_inputs(ctx, rng, J, dev)
            refs = {k: plain() for k, _, plain in enc_calls(ctx, inputs, 0)}
            pk, u_b, e_d, _ = inputs
            ref_scratch = fused_ops.encrypt_transform_plain(
                u_b, pk, e_d, ctx.tables_full)
            took, refused = [], []
            for B in CLUSTER_BS:
                if enc_fits(B, n):
                    compare("encrypt_fused", enc_transform(ctx, inputs, B),
                            ref_scratch, errs)
                for kname, kern, _ in enc_calls(ctx, inputs, B):
                    if enc_fits(B, n):
                        compare(kname, kern(), refs[kname], errs)
                        continue
                    try:
                        kern()
                    except RuntimeError:
                        continue
                    raise AssertionError(f"{name} {kname} B={B}: launched "
                                         f"where two n/B buffers do not fit")
                (took if enc_fits(B, n) else refused).append(B)
        log(f"check {name} K5 (J = 1, 3) and kernel 18 at cluster sizes "
            f"B={took}: equal to their plain versions; B={refused}: refused "
            f"(two n/B buffers past 128 KB a block)")


def raw_launch(lib, name: str, *args) -> None:
    rc = getattr(lib, name)(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")


def encrypt_cluster_times(dev, rng, errs: dict) -> dict:
    """K5 (transform and tail) and kernel 18 at the ENC_TIME_CASES shapes
    at every cluster size B a launch takes: device us per call
    (torch.profiler) and ms per call of 20 back to back (CUDA events), the
    output held against its plain version; and the transform alone (K5:
    its scratch held against encrypt_transform_plain), device us."""
    res, ctxs = {}, {}
    for label, name, J in ENC_TIME_CASES:
        if name not in ctxs:
            ctxs[name] = BFVContext.build(get_bfv_params(name), device=dev,
                                          fusion="op")
        ctx = ctxs[name]
        p, tf = ctx.params, ctx.tables_full
        inputs = enc_inputs(ctx, rng, max(J, 1), dev)
        pk, u_b, e_d, _ = inputs
        kname, _, plain = enc_calls(ctx, inputs, 0)[0 if J else 1]
        ref = plain()
        ref_out = (fused_ops.encrypt_transform_plain(u_b, pk, e_d, tf) if J
                   else ref)
        if J:
            out = torch.empty((J, 2, p.r, p.n), dtype=torch.int64, device=dev)
            entry, args = ENC_ENTRIES[0], (u_b.data_ptr(), pk.data_ptr(),
                                           e_d.data_ptr(), out.data_ptr(),
                                           *tf.kernel_args(), J, p.r, p.logn)
        else:
            out = torch.empty((2, p.r, p.n), dtype=torch.int64, device=dev)
            entry, args = ENC_ENTRIES[1], (u_b[0].data_ptr(), pk.data_ptr(),
                                           out.data_ptr(), *tf.kernel_args(),
                                           p.r, p.logn)
        for B in CLUSTER_BS:
            key = f"{label} {name}" + (f" J={J}" if J else "") + f" B={B}"
            if not enc_fits(B, p.n):
                res[key] = "refused"
                continue
            kern = enc_calls(ctx, inputs, B)[0 if J else 1][1]
            compare(kname, kern(), ref, errs)
            def transform(B=B):
                raw_launch(cuda.library(), entry, *args, B)
            transform()
            compare(kname, out, ref_out, errs)
            res[key] = {"rule": B == ntt_stage.cluster_size(p.n),
                        "us": device_us(kern), "ms": kernel_ms(kern),
                        "transform_us": device_us(transform)}
    return res


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


def odd_t_params(p: BFVParams) -> BFVParams:
    """p with an odd batching prime t (t = 1 mod 2n, about 17 bits)."""
    return BFVParams(name=f"{p.name}_oddt", n=p.n, q=p.q, psi=p.psi,
                     t=primegen.find_plain_modulus(p.n, 17), gamma=p.gamma)


def spmd_cases(p: BFVParams, dev, rng):
    """(kernel, label, wrapper call, plain call, Work) for kernels 16-18 at
    the rank shapes of p's RNS-sharded program (rows SPMD_BANDS), for p's
    power-of-two t and an odd prime t (18 does not read t); kernel 17 also
    over a level-1 rank whose last row is a q = 1 pad row."""
    cases = []
    n = p.n
    for pt in (p, odd_t_params(p)):
        for lo, hi in SPMD_BANDS:
            rl, label = hi - lo, f"{pt.name} rows {lo}-{hi}"
            if pt is p:
                tb = ntt.NTTTables.build(p.q[lo:hi], p.psi[lo:hi], n, dev)
                u_b, _ = sampling.encrypt_draws_compact(n, nonce=1,
                                                        device=dev)
                pk = rand_res(rng, p.q[lo:hi], n, (2,), dev)
                cases.append((
                    "encrypt_front", label,
                    lambda u=u_b, k=pk, tb=tb: fused_ops.encrypt_front(u, k, tb),
                    lambda u=u_b, k=pk, tb=tb: fused_ops.encrypt_front_plain(
                        u, k, tb),
                    Work(nbytes(u_b, pk, *tables(tb), pk),
                         shoup=transform_butterflies(3 * rl, n) + 2 * rl * n,
                         mont=2 * rl * n)))
            tc = bfv_tail.build_tail_consts_padded(pt, lo, hi, dev)
            c, e = (rand_res(rng, pt.q[lo:hi], n, (2,), dev)
                    for _ in range(2))
            ra = torch.from_numpy(rng.integers(0, pt.q[-1], (2, n))).to(dev)
            m = torch.from_numpy(rng.integers(0, pt.t, n)).to(dev)
            out = 2 * rl * n
            cases.append((
                "encrypt_tail_padded", label,
                lambda c=c, e=e, ra=ra, m=m, tc=tc:
                    bfv_tail.encrypt_tail_padded(c, e, ra, m, tc),
                lambda c=c, e=e, ra=ra, m=m, tc=tc:
                    bfv_tail.encrypt_tail_padded_plain(c, e, ra, m, tc),
                Work(nbytes(c, e, ra, m, tc.per_mod) + 8 * out, mont=out,
                     mod_nu=out + out // 2, mullo=out // 2)))
            levels = ((0, hi), (1, min(hi, pt.r - 1))) if hi == pt.r else (
                (0, hi),)
            for level, top in levels:
                cp = spmd._chain_params(pt, level)
                dc = bfv_tail.build_dec_tail_consts_padded(cp, lo, top,
                                                           pad_to=hi,
                                                           device=dev)
                x, c0 = (rand_res(rng, pt.q[lo:hi], n, (), dev)
                         for _ in range(2))
                cases.append((
                    "decrypt_tail_partial", f"{label} level {level}",
                    lambda x=x, c0=c0, dc=dc:
                        bfv_tail.decrypt_tail_partial(x, c0, dc),
                    lambda x=x, c0=c0, dc=dc:
                        bfv_tail.decrypt_tail_partial_plain(x, c0, dc),
                    Work(nbytes(x, c0, dc.per_mod, dc.glob) + 16 * n,
                         mont=3 * rl * n, mullo=rl * n)))
    return cases


def spmd_mult_cases(p: BFVParams, dev, rng):
    """(kernel, label, wrapper call, plain call, Work) for the sharded
    EvalMult's kernels at p's rank shapes (rows SPMD_BANDS): kernel 20 over
    the (k, n) digits and the rank's (2, k, rl, n) key rows, 21a-c in band
    form over mul's operands ((2, 2, k, n); (3, k, n) with the band's
    (3, rl, n); (3, k+1, n)), and kernel 16's drop launch over (2, rl, n)."""
    n, k = p.n, p.r - 1
    aux = behz.AuxBase.build(p)
    mc = behz_kernels.SpmdMultConsts.build(p, aux, dev)
    mb = mc.banks
    banks = [mb.qsrc, mb.tgt, mb.amat, mb.bsrc, mb.bmat, mb.bfin, mb.glob]
    cases = []
    for lo, hi in SPMD_BANDS:
        rl, label = hi - lo, f"{p.name} rows {lo}-{hi}"
        live = min(hi, k) - lo
        tb = ntt.NTTTables.build(p.q[lo:hi], p.psi[lo:hi], n, dev)
        c2 = rand_res(rng, p.q[:k], n, (), dev)
        ksk = rand_res(rng, p.q[lo:hi], n, (2, k), dev)
        xa = rand_res(rng, p.q[:k], n, (2, 2), dev)
        xq = rand_res(rng, p.q[:k], n, (3,), dev)
        xb = rand_res(rng, aux.bsk[lo:hi], n, (3,), dev)
        fl = rand_res(rng, aux.bsk, n, (3,), dev)
        cc = rand_res(rng, p.q[lo:hi], n, (2,), dev)
        ra = torch.from_numpy(rng.integers(0, p.q[-1], (2, n))).to(dev)
        tc = spmd_mult.drop_consts(mc, p.q[-1], lo, hi)
        coefs_a, coefs_f, out = 4 * n, 3 * n, 2 * rl * n
        cases += [
            ("keyswitch_front", label,
             lambda c=c2, s=ksk, tb=tb: fused_ops.keyswitch_front(c, s, tb),
             lambda c=c2, s=ksk, tb=tb: fused_ops.keyswitch_front_plain(
                 c, s, tb),
             Work(nbytes(c2, ksk, *tables(tb)) + 8 * out,
                  shoup=transform_butterflies((k + 2) * rl, n) + out,
                  mod_nu=k * rl * n, mont=k * out)),
            ("behz_rns_to_bsk_rows", label,
             lambda x=xa, lo=lo, rl=rl: behz_kernels.rns_to_bsk_rows(
                 x, mc, lo, rl),
             lambda x=xa, lo=lo, rl=rl: behz_kernels.rns_to_bsk_rows_plain(
                 x, mc, lo, rl),
             Work(nbytes(xa, *banks) + 8 * coefs_a * rl,
                  shoup=coefs_a * (k + rl * (k + 2)),
                  mul32=coefs_a * (k + 1))),
            ("behz_fast_floor_rows", label,
             lambda a=xq, b=xb, lo=lo, rl=rl: behz_kernels.fast_floor_rows(
                 a, b, mc, lo, rl),
             lambda a=xq, b=xb, lo=lo, rl=rl:
                 behz_kernels.fast_floor_rows_plain(a, b, mc, lo, rl),
             Work(nbytes(xq, xb, *banks) + nbytes(xb),
                  shoup=coefs_f * (k + rl * (k + 2)))),
            ("behz_bsk_to_q_rows", label,
             lambda x=fl, lo=lo, rl=rl: behz_kernels.bsk_to_q_rows(
                 x, mc, lo, rl),
             lambda x=fl, lo=lo, rl=rl: behz_kernels.bsk_to_q_rows_plain(
                 x, mc, lo, rl),
             Work(nbytes(fl, *banks) + 8 * coefs_f * rl,
                  shoup=coefs_f * (2 * k + 1 + live * (k + 1)))),
            ("encrypt_tail_padded", f"{label} drop",
             lambda c=cc, ra=ra, tc=tc: bfv_tail.drop_last_padded(c, ra, tc),
             lambda c=cc, ra=ra, tc=tc: bfv_tail.drop_last_padded_plain(
                 c, ra, tc),
             Work(nbytes(cc, ra, tc.per_mod) + 8 * out, mont=out,
                  mod_nu=out)),
        ]
    return cases


def spmd_messages(p: BFVParams) -> np.ndarray:
    return np.random.default_rng(SEED + 5).integers(0, p.t, (SPMD_MSGS, p.n))


def drive_spmd(sctx: spmd.SpmdBFVContext, msgs: np.ndarray) -> dict:
    """keygen, encrypt of each message, add and sub of the first two,
    decrypt of each, mod_switch_to_next of the first and its level-1
    decrypt; each op's collectives.  Returns the rank's local tensors."""
    ops: dict[str, list] = {}

    def counted(name, fn):
        pmesh.collectives.clear()
        y = fn()
        ops.setdefault(name, []).append(list(pmesh.collectives))
        return y

    sk, pk = counted("keygen", lambda: sctx.keygen(nonce=1))
    cts = [counted("encrypt", lambda j=j: sctx.encrypt(pk, msgs[j],
                                                       nonce=j + 1))
           for j in range(len(msgs))]
    add = counted("add", lambda: sctx.add(cts[0], cts[1]))
    sub = counted("sub", lambda: sctx.sub(cts[0], cts[1]))
    outs = [counted("decrypt", lambda c=c: sctx.decrypt(sk, c)) for c in cts]
    sw = counted("mod_switch", lambda: sctx.mod_switch_to_next(cts[0]))
    res = dict(sk=sk, pk=pk, add=add, sub=sub, sw=sw,
               dec_add=sctx.decrypt(sk, add), dec_sub=sctx.decrypt(sk, sub),
               dec_sw=sctx.decrypt(sk, sw, level=1))
    res.update({f"ct{j}": c for j, c in enumerate(cts)})
    res.update({f"dec{j}": o for j, o in enumerate(outs)})
    torch.cuda.synchronize()
    return {"local": {k: v.to_local() for k, v in res.items()},
            "dtensor": res, "collectives": ops}


def check_spmd(p: BFVParams, local: dict, collectives: dict,
               msgs: np.ndarray, ref: dict, ref_sw) -> None:
    """Round trips (level 1 included), add / sub mod t, keys and live
    ciphertext rows equal to the single-card run `ref` and mod switch
    `ref_sw`, and the collectives: keygen none, encrypt one (2, n)
    all-reduce, decrypt one (3, n), mod_switch one (2, n)."""
    t, r, n = p.t, p.r, p.n
    m = [torch.from_numpy(msgs[j]).to(local["dec0"].device)
         for j in range(len(msgs))]
    want = {f"dec{j}": m[j] for j in range(len(msgs))}
    want.update(dec_add=(m[0] + m[1]) % t, dec_sub=(m[0] - m[1]) % t,
                dec_sw=m[0])
    for k, w in want.items():
        if not torch.equal(local[k], w):
            raise AssertionError(f"SPMD {p.name}: {k} does not decrypt to "
                                 f"its message")
    same = (torch.equal(local["sk"], ref["sk"]) and
            torch.equal(local["pk"], ref["pk"]) and
            all(torch.equal(local[f"ct{j}"][:, :r - 1], ref["cts"][j])
                for j in range(len(msgs))) and
            torch.equal(local["sw"][:, :r - 2], ref_sw))
    if not same:
        raise AssertionError(f"SPMD {p.name}: keys / live ciphertext rows != "
                             f"the single-card BFVContext")
    budget = {"keygen": [[]], "encrypt": [[("all_reduce", (2, n))]] * len(
        msgs), "add": [[]], "sub": [[]],
              "decrypt": [[("all_reduce", (3, n))]] * len(msgs),
              "mod_switch": [[("all_reduce", (2, n))]]}
    got = {k: [[(op, tuple(sh)) for op, sh in call] for call in v]
           for k, v in collectives.items()}
    if got != budget:
        raise AssertionError(f"SPMD {p.name}: collectives {got}, expected "
                             f"{budget}")


def drive_spmd_mult(mctx: spmd_mult.SpmdMultContext, res: dict) -> dict:
    """On drive_spmd's keys and first two ciphertexts: relin_keygen, mul,
    relinearize, mul with rlk, decrypt3, galois_keygen([SPMD_GALOIS]) and
    apply_galois of the first, then the decrypts of the relinearized and
    rotated ciphertexts; each op's collectives.  Returns the rank's local
    tensors."""
    ops: dict[str, list] = {}

    def counted(name, fn):
        pmesh.collectives.clear()
        y = fn()
        ops.setdefault(name, []).append(list(pmesh.collectives))
        return y

    base, ds = mctx.base, res["dtensor"]
    sk, c0, c1 = ds["sk"], ds["ct0"], ds["ct1"]
    rlk = counted("relin_keygen", lambda: mctx.relin_keygen(sk, nonce=1))
    mul3 = counted("mul", lambda: mctx.mul(c0, c1))
    rel = counted("relinearize", lambda: mctx.relinearize(mul3, rlk))
    gk = counted("galois_keygen", lambda: mctx.galois_keygen(
        sk, [SPMD_GALOIS], nonce=1))[SPMD_GALOIS]
    gal = counted("apply_galois", lambda: mctx.apply_galois(c0, SPMD_GALOIS,
                                                            gk))
    out = dict(rlk=rlk, mul3=mul3, rel=rel, gk=gk, gal=gal,
               mul_rlk=mctx.mul(c0, c1, rlk=rlk),
               dec3=counted("decrypt3", lambda: mctx.decrypt3(sk, mul3)),
               dec_rel=base.decrypt(sk, rel), dec_gal=base.decrypt(sk, gal))
    torch.cuda.synchronize()
    return {"local": {k: v.to_local() for k, v in out.items()},
            "dtensor": out, "collectives": ops}


def spmd_mult_reference(ctx: BFVContext, ref: dict) -> dict:
    """drive_spmd_mult's keys and ciphertexts from the single card, on
    drive(ctx)'s keys and ciphertexts `ref`."""
    sk, (c0, c1) = ref["sk"], ref["cts"][:2]
    rlk = ctx.relin_keygen(sk, nonce=1)
    mul3 = ctx.mul(c0, c1)
    gk = ctx.galois_keygen(sk, [SPMD_GALOIS], nonce=1)[SPMD_GALOIS]
    return dict(rlk=rlk, mul3=mul3, rel=ctx.relinearize(mul3, rlk), gk=gk,
                gal=ctx.apply_galois(c0, SPMD_GALOIS, gk))


def check_spmd_mult(p: BFVParams, local: dict, collectives: dict,
                    msgs: np.ndarray, ref: dict) -> None:
    """The product's decrypts (decrypt3, relinearized) equal the negacyclic
    m1 m2 mod t and the rotation's tau_g(m1); keys and live rows equal the
    single card's `ref` (spmd_mult_reference), mul's pad row 0; the
    collectives: mul four all-gathers, relinearize and apply_galois one
    (r, n) all-gather and one (2, n) all-reduce, decrypt3 one (3, n)
    all-reduce, the keygens none."""
    r, n, k = p.r, p.n, p.r - 1
    dev = local["dec3"].device
    prod = negacyclic_mod_t(msgs[0], msgs[1], p, dev)
    want = {"dec3": prod, "dec_rel": prod,
            "dec_gal": tau_mod_t(msgs[0], SPMD_GALOIS, p, dev)}
    for key, w in want.items():
        if not torch.equal(local[key], w):
            raise AssertionError(f"SPMD EvalMult {p.name}: {key} does not "
                                 f"decrypt to its mod-t result")
    same = all(torch.equal(local[key], ref[key]) for key in ("rlk", "gk"))
    same = same and all(torch.equal(local[key][:, :k], ref[w]) for key, w in
                        (("mul3", "mul3"), ("rel", "rel"),
                         ("mul_rlk", "rel"), ("gal", "gal")))
    if not same or local["mul3"][:, k].any():
        raise AssertionError(f"SPMD EvalMult {p.name}: keys / live rows != "
                             f"the single-card BFVContext, or mul's pad row "
                             f"not 0")
    switch = [[("all_gather", (r, n)), ("all_reduce", (2, n))]]
    budget = {"relin_keygen": [[]], "galois_keygen": [[]],
              "mul": [[("all_gather", (2, r, n))] * 2
                      + [("all_gather", (3, r, n))] * 2],
              "relinearize": switch, "apply_galois": switch,
              "decrypt3": [[("all_reduce", (3, n))]]}
    got = {k: [[(op, tuple(sh)) for op, sh in call] for call in v]
           for k, v in collectives.items()}
    if got != budget:
        raise AssertionError(f"SPMD EvalMult {p.name}: collectives {got}, "
                             f"expected {budget}")


def free_address() -> str:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return f"tcp://localhost:{sock.getsockname()[1]}"


def spmd_worker(rank: int, R: int, address: str, out: Path) -> None:
    """One rank of the one-card gloo run (chip_smoke.py re-run as
    `--spmd-worker rank R address out`): first an all-reduce of a CUDA
    tensor over gloo (a refusal ends the rank with an error, and the run
    fails), then the SPMD path at SPMD_SET and the sharded EvalMult on its
    keys and ciphertexts; the rank's local tensors and collectives go to
    rank<rank>.npz / .json."""
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    multihost.initialize(address, R, rank, backend="gloo")
    try:
        x = torch.full((4,), rank + 1, dtype=torch.int64, device=dev)
        torch.distributed.all_reduce(x)
        if x.tolist() != [R * (R + 1) // 2] * 4:
            raise AssertionError(f"gloo all_reduce of CUDA tensors: {x}")
        p = get_bfv_params(SPMD_SET)
        sctx = spmd.SpmdBFVContext.build(p)
        if (sctx.device != dev or sctx.shards != R
                or pmesh.collectives):
            raise AssertionError(f"rank {rank}: built on {sctx.device} over "
                                 f"{sctx.shards} ranks")
        res = drive_spmd(sctx, spmd_messages(p))
        resm = drive_spmd_mult(spmd_mult.SpmdMultContext.build(sctx), res)
        local = {**res["local"], **resm["local"]}
        np.savez(out / f"rank{rank}.npz",
                 **{k: v.cpu().numpy() for k, v in local.items()})
        (out / f"rank{rank}.json").write_text(json.dumps(
            {**res["collectives"], **resm["collectives"]}))
    finally:
        torch.distributed.destroy_process_group()


def run_spmd_ranks(R: int) -> dict:
    """SPMD_SET's path and the sharded EvalMult in R processes on the one
    card over gloo: each rank's local tensors put back together along the
    sharded axis (the plaintexts, replicated, must agree on every rank).
    Raises with the log of any rank that fails."""
    address = free_address()
    with tempfile.TemporaryDirectory() as d:
        out = Path(d)
        wait_workers(start_workers(
            ["--spmd-worker"], [[str(rank), str(R), address, str(out)]
                                for rank in range(R)]), f"SPMD R={R}")
        ranks = [dict(np.load(out / f"rank{k}.npz")) for k in range(R)]
        colls = [json.loads((out / f"rank{k}.json").read_text())
                 for k in range(R)]
    whole = {}
    for k in ranks[0]:
        parts = [torch.from_numpy(rk[k]) for rk in ranks]
        if k.startswith("dec"):
            if not all(torch.equal(parts[0], q) for q in parts[1:]):
                raise AssertionError(f"SPMD R={R}: {k} differs across ranks")
            whole[k] = parts[0]
        else:
            whole[k] = torch.cat(parts, dim=SPMD_SHARD_DIM.get(k, 1))
    if any(c != colls[0] for c in colls[1:]):
        raise AssertionError(f"SPMD R={R}: collectives differ across ranks")
    return {"local": whole, "collectives": colls[0]}


def kge_times(ctx, sk, pk, ct, m0, reps: int) -> dict:
    """keygen, encrypt and decrypt of one message, ms per call."""
    return {
        "keygen": median_ms(lambda: ctx.keygen(nonce=1), reps),
        "encrypt": median_ms(lambda: ctx.encrypt(pk, m0, nonce=1), reps),
        "decrypt": median_ms(lambda: ctx.decrypt(sk, ct), reps),
    }


def mult_turn_times(ctx, a, b, keys: dict, reps: int) -> dict:
    """mul, relinearize and apply_galois(SPMD_GALOIS) of one message, ms
    per call; `keys` holds mul3, rlk and gk (drive_spmd_mult's or
    spmd_mult_reference's)."""
    return {
        "mul": median_ms(lambda: ctx.mul(a, b), reps),
        "relinearize": median_ms(lambda: ctx.relinearize(keys["mul3"],
                                                         keys["rlk"]), reps),
        "apply_galois": median_ms(lambda: ctx.apply_galois(
            a, SPMD_GALOIS, keys["gk"]), reps),
    }


def idx_work(x, idx, tb, inverse: bool) -> Work:
    """Kernel 12 over B polynomials: a transform each, x in and out once,
    one direction's tables and the index."""
    return Work(nbytes(x, idx, *tables(tb, "inv" if inverse else "fwd"), x),
                shoup=transform_butterflies(x.shape[0], tb.n)
                + (x.numel() if inverse else 0))


def ops_cases(rng, dev):
    """(kernel, label, wrapper call, plain call, Work) for kernels 12, 14
    and 15 at the shapes their entry points take on the ops path: 12 over
    the standard index (B = r) and a permuted one (B = 2r + 1) in both
    directions; 14 over (2, r, n) c and e; 15 over the r-1 kept moduli."""
    cases = []
    for name in IDX_CHECK_SETS:
        p = get_bfv_params(name)
        tb = ntt.tables_for(p, device=dev)
        for kind, idx in (("standard", np.arange(p.r)),
                          ("permuted", rng.permutation(
                              np.arange(2 * p.r + 1) % p.r))):
            # a host index, as on the ops path (a CUDA one costs the host's
            # range check a device sync)
            idx = torch.from_numpy(idx.astype(np.int32))
            x = torch.stack([torch.from_numpy(rng.integers(
                0, p.q[i], p.n)).to(dev) for i in idx.tolist()])
            for inverse in (False, True):
                cases.append((
                    "ntt_transform_idx",
                    f"{name} {kind} B={len(idx)} "
                    f"{'inv' if inverse else 'fwd'}",
                    lambda x=x, i=idx, tb=tb, v=inverse:
                        ntt_stage.ntt_transform_idx(x, tb, i, inverse=v),
                    lambda x=x, i=idx, tb=tb, v=inverse:
                        ntt_stage.ntt_transform_idx_plain(x, tb, i,
                                                          inverse=v),
                    idx_work(x, idx, tb, inverse)))
    for name in TAIL_CHECK_SETS:
        p = get_bfv_params(name)
        tc = bfv_tail.TailConsts.build(p, dev)
        c, e = (rand_res(rng, p.q, p.n, (2,), dev) for _ in range(2))
        m = torch.from_numpy(rng.integers(0, p.t, p.n)).to(dev)
        out = 2 * (p.r - 1) * p.n
        cases.append((
            "encrypt_tail", name,
            lambda c=c, e=e, m=m, tc=tc: bfv_tail.encrypt_tail(c, e, m, tc),
            lambda c=c, e=e, m=m, tc=tc: bfv_tail.encrypt_tail_plain(
                c, e, m, tc),
            Work(nbytes(c, e, m, tc.per_mod) + 8 * out, mont=out,
                 mod_nu=out + out // 2, mullo=out // 2)))
    for name in DEC_FUSED_SETS:
        p = get_bfv_params(name)
        td = ntt.tables_for(p, p.r - 1, device=dev)
        dt = bfv_tail.DecTailConsts.build(p, dev)
        x, sk, c0 = (rand_res(rng, p.q[:-1], p.n, (), dev) for _ in range(3))
        cases.append((
            "decrypt_fused", name,
            lambda x=x, sk=sk, c0=c0, td=td, dt=dt: bfv_tail.decrypt_fused(
                x, sk, c0, td, dt),
            lambda x=x, sk=sk, c0=c0, td=td, dt=dt:
                bfv_tail.decrypt_fused_plain(x, sk, c0, td, dt),
            decrypt_fused_work(x, sk, c0, td, dt)))
    return cases


def decrypt_fused_work(x, sk, c0, td, dt) -> Work:
    """Kernel 15: kernel 8's inverse (the Montgomery product, the
    butterflies, the n^-1 Shoup) and K2's residue loop, x, sk and c0 read
    once and the (n,) plaintext written once."""
    rk, n = x.shape
    return Work(nbytes(x, sk, c0, *tables(td, "inv"), dt.per_mod, dt.glob)
                + 8 * n, shoup=transform_butterflies(rk, n) + rk * n,
                mont=rk * n + n * (3 * rk + 1), mullo=n * (rk + 1))


def drive_ops(ctx: BFVContext, pk, sk, msgs: np.ndarray, dev) -> dict:
    """The op-level entry points on real ciphertexts: encrypt of each
    message as NTT(u) (kernel 12 over the standard index), INTT(NTT(u) .
    pk) and kernel 14 with the message's own draws; decrypt as NTT(c1)
    (kernel 12 over the kept moduli) then kernel 15; and kernel 12's
    inverse over a permuted index, back to the draws' residues."""
    p = ctx.params
    tf, td = ctx.tables_full, ctx.tables_drop
    full = torch.arange(p.r, dtype=torch.int32)
    kept = torch.arange(p.r - 1, dtype=torch.int32)
    cts, outs, u_res = [], [], []
    for j in range(len(msgs)):
        u_b, e_d = sampling.encrypt_draws_compact(p.n, nonce=j + 1,
                                                  device=dev)
        u = sampling.small_res(u_b, tf.ms.q)
        u_res.append(u)
        u_ntt = ntt_stage.ntt_forward(u, tf, mod_idx=full)
        c = ntt_stage.ntt_inverse_mul(torch.stack([u_ntt, u_ntt]), pk, tf)
        ct = bfv_tail.encrypt_tail(c, sampling.small_res(e_d, tf.ms.q),
                                   torch.from_numpy(msgs[j]).to(dev),
                                   ctx.tail_consts)
        x = ntt_stage.ntt_forward(ct[1].contiguous(), td, mod_idx=kept)
        outs.append(bfv_tail.decrypt_fused(x, sk[:p.r - 1].contiguous(),
                                           ct[0].contiguous(), td,
                                           ctx.dec_tail_consts))
        cts.append(ct)
    perm = torch.from_numpy(np.random.default_rng(SEED + 7).permutation(
        np.arange(2 * p.r + 1) % p.r).astype(np.int32))
    rows = torch.stack([u_res[0][i] for i in perm.tolist()])
    fwd = ntt_stage.ntt_forward(rows, tf, mod_idx=perm)
    back = ntt_stage.ntt_inverse(fwd, tf, mod_idx=perm)
    torch.cuda.synchronize()
    return dict(cts=cts, outs=outs, rows=rows, back=back)


def coef_path(p: BFVParams, C: int, rng, dev, errs: dict) -> dict:
    """The coefficient-sharded transform at C shards in one process, every
    shard driven stage by stage with its partner's tensor handed in (what
    ppermute brings): forward of x (r, n) and INTT(x (.) y), counted (the
    reference launches come after).  Each shard's offset launch is held
    against the plain local stages on its inputs, the assembled result
    against the plain whole transform and kernels 7 and 8, and the
    cross-stage glue of every stage against its plain version."""
    tb = ntt.tables_for(p, device=dev)
    logc, S = sharded.log2_shards(C), p.n // C
    x, y = (rand_res(rng, p.q, p.n, (), dev) for _ in range(2))
    split = lambda v: [v[..., c * S:(c + 1) * S].contiguous()
                       for c in range(C)]

    def cross(xs, s, inverse):
        k = sharded.cross_stride(C, s)
        return [coef_kernels.cross_stage(xs[c], xs[c ^ k], tb, C, s, c,
                                         inverse) for c in range(C)]
    reset_counts()
    xs = split(x)
    for s in range(logc):
        xs = cross(xs, s, False)
    fwd_in = xs
    fwd_out = [coef_kernels.local_forward(xs[c], tb, logc, c)
               for c in range(C)]
    fwd = torch.cat(fwd_out, -1)
    ys, inv_in = split(y), split(x)
    xs = inv_out = [coef_kernels.local_inverse_mul(v, ys[c], tb, logc, c)
                    for c, v in enumerate(inv_in)]
    for s in reversed(range(logc)):
        xs = cross(xs, s, True)
    invmul = torch.cat(xs, -1)
    torch.cuda.synchronize()
    cnt = read_counts()
    # each shard's offset launch against the plain local stages on the
    # same inputs, then the assembled transforms against the plain whole
    # ones and kernels 7 and 8 on the whole polynomial
    for c in range(C):
        compare("ntt_transform", fwd_out[c],
                sharded.local_forward_stages(fwd_in[c], tb, C, c), errs)
        compare("ntt_inverse_mul", inv_out[c],
                coef_kernels.local_inverse_mul_plain(inv_in[c], ys[c], tb, C,
                                                     c), errs)
    compare("ntt_transform", fwd, ntt_stage.ntt_forward_plain(x, tb), errs)
    compare("ntt_inverse_mul", invmul,
            ntt_stage.ntt_inverse_mul_plain(x, y, tb), errs)
    if not (torch.equal(fwd, ntt_stage.ntt_forward(x, tb)) and
            torch.equal(invmul, ntt_stage.ntt_inverse_mul(x, y, tb))):
        raise AssertionError(f"coef-sharded transform {p.name} C={C} != "
                             f"kernels 7 and 8 on the whole polynomial")
    for inverse in (False, True):
        for s in range(logc):
            xs, k = split(x), sharded.cross_stride(C, s)
            for c in range(C):
                plain = (sharded.cross_inverse_stage(xs[c], xs[c ^ k], tb, C,
                                                     s, c, halve=False)
                         if inverse else sharded.cross_forward_stage(
                             xs[c], xs[c ^ k], tb, C, s, c))
                compare("coef_cross_stage", coef_kernels.cross_stage(
                    xs[c], xs[c ^ k], tb, C, s, c, inverse), plain, errs)
    glue = split(x)
    return {"counts": cnt, "cross": (
        lambda: coef_kernels.cross_stage(glue[0], glue[1], tb, C, 0, 0,
                                         False),
        lambda: sharded.cross_forward_stage(glue[0], glue[1], tb, C, 0, 0),
        Work(3 * nbytes(glue[0]), shoup=glue[0].numel()))}


def drive_spmd2d(ctx2: spmd2d.Spmd2DBFVContext, msgs: np.ndarray) -> dict:
    """keygen, encrypt of each message, decrypt of each; each op's
    collectives.  Returns the rank's local tensors."""
    ops: dict[str, list] = {}

    def counted(name, fn):
        pmesh.collectives.clear()
        y = fn()
        ops.setdefault(name, []).append(list(pmesh.collectives))
        return y

    sk, pk = counted("keygen", lambda: ctx2.keygen(nonce=1))
    cts = [counted("encrypt", lambda j=j: ctx2.encrypt(pk, msgs[j],
                                                       nonce=j + 1))
           for j in range(len(msgs))]
    outs = [counted("decrypt", lambda c=c: ctx2.decrypt(sk, c)) for c in cts]
    res = dict(sk=sk, pk=pk)
    res.update({f"ct{j}": c for j, c in enumerate(cts)})
    res.update({f"dec{j}": o for j, o in enumerate(outs)})
    torch.cuda.synchronize()
    return {"local": {k: v.to_local() for k, v in res.items()},
            "dtensor": res, "collectives": ops}


def check_spmd2d(p: BFVParams, whole: dict, collectives: dict, R: int,
                 C: int, msgs: np.ndarray, ref: dict) -> None:
    """Round trips; keys and live ciphertext rows equal to the single-card
    run `ref`; the collectives JAX's budget: keygen 3 log2 C ppermutes of
    the (rl, S) block, encrypt and decrypt 2 log2 C and one all-reduce
    ((2, S) and (3, S))."""
    r, rl, S = p.r, p.r // R, p.n // C
    logc = sharded.log2_shards(C)
    for j in range(len(msgs)):
        if not np.array_equal(whole[f"dec{j}"].cpu().numpy(), msgs[j]):
            raise AssertionError(f"2-D {R}x{C}: dec{j} != m{j}")
    same = (torch.equal(whole["sk"], ref["sk"]) and
            torch.equal(whole["pk"], ref["pk"]) and
            all(torch.equal(whole[f"ct{j}"][:, :r - 1], ref["cts"][j])
                for j in range(len(msgs))))
    if not same:
        raise AssertionError(f"2-D {R}x{C}: keys / live ciphertext rows != "
                             f"the single-card BFVContext")
    blk = ("ppermute", (rl, S))
    budget = {"keygen": [[blk] * (3 * logc)],
              "encrypt": [[blk] * logc + [("ppermute", (2, rl, S))] * logc
                          + [("all_reduce", (2, S))]] * len(msgs),
              "decrypt": [[blk] * (2 * logc)
                          + [("all_reduce", (3, S))]] * len(msgs)}
    got = {k: [[(op, tuple(sh)) for op, sh in call] for call in v]
           for k, v in collectives.items()}
    if got != budget:
        raise AssertionError(f"2-D {R}x{C}: collectives {got}, expected "
                             f"{budget}")


def spmd2d_worker(rank: int, R: int, C: int, address: str,
                  out: Path) -> None:
    """One rank of a one-card gloo run of the 2-D program (chip_smoke.py
    re-run as `--spmd2d-worker rank R C address out`) on an (R, C) pod
    mesh at SPMD_SET: drive_spmd2d, counts read around it; the rank's
    local tensors, collectives and counts go to rank<rank>.npz / .json."""
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    multihost.initialize(address, R * C, rank, backend="gloo")
    try:
        p = get_bfv_params(SPMD_SET)
        ctx2 = spmd2d.Spmd2DBFVContext.build(
            p, mesh=multihost.pod_mesh(R, C))
        reset_counts()
        res = drive_spmd2d(ctx2, spmd_messages(p))
        np.savez(out / f"rank{rank}.npz",
                 **{k: v.cpu().numpy() for k, v in res["local"].items()})
        (out / f"rank{rank}.json").write_text(json.dumps(
            {"collectives": res["collectives"], "counts": read_counts(),
             "block": [ctx2.rns_index, ctx2.coef_index]}))
    finally:
        torch.distributed.destroy_process_group()


def start_workers(flag: list, rank_args: list) -> list:
    """This script re-run once per rank with `flag` and the rank's
    arguments, all started together."""
    return [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), *flag, *args],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for args in rank_args]


def wait_workers(procs: list, label: str) -> None:
    """Wait for start_workers' processes (killing any left after the
    timeout); raise with the log of any that failed."""
    try:
        logs = [proc.communicate(timeout=600)[0] for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for rank, (proc, text) in enumerate(zip(procs, logs)):
        if proc.returncode != 0:
            raise AssertionError(f"{label}: worker {rank} failed "
                                 f"({proc.returncode}):\n{text}")


def start_spmd2d_ranks(R: int, C: int, out: Path) -> list:
    address = free_address()
    return start_workers(["--spmd2d-worker"],
                         [[str(rank), str(R), str(C), address, str(out)]
                          for rank in range(R * C)])


def finish_spmd2d_ranks(R: int, C: int, procs: list, out: Path) -> dict:
    """Wait for start_spmd2d_ranks' workers; their blocks put back together
    (rank i C + c holds rows block i and coefficients block c); the
    plaintexts must agree across the rns axis, the collectives across all
    ranks."""
    wait_workers(procs, f"2-D {R}x{C}")
    ranks = [dict(np.load(out / f"rank{k}.npz")) for k in range(R * C)]
    meta = [json.loads((out / f"rank{k}.json").read_text())
            for k in range(R * C)]
    if [m["block"] for m in meta] != [[i, c] for i in range(R)
                                      for c in range(C)]:
        raise AssertionError(f"2-D {R}x{C}: rank blocks {meta}")
    whole = {}
    for k in ranks[0]:
        blocks = [[torch.from_numpy(ranks[i * C + c][k]) for c in range(C)]
                  for i in range(R)]
        if k.startswith("dec"):
            rows = [torch.cat(b, -1) for b in blocks]
            if not all(torch.equal(rows[0], q) for q in rows[1:]):
                raise AssertionError(f"2-D {R}x{C}: {k} differs across rns")
            whole[k] = rows[0]
        else:
            dim = SPMD_SHARD_DIM.get(k, 1)
            whole[k] = torch.cat([torch.cat(b, -1) for b in blocks], dim)
    if any(m["collectives"] != meta[0]["collectives"] for m in meta[1:]):
        raise AssertionError(f"2-D {R}x{C}: collectives differ across ranks")
    return {"local": whole, "collectives": meta[0]["collectives"],
            "counts": [m["counts"] for m in meta]}


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
    ab_build = start_local_ab()
    ptxas = start_ptxas_report()
    cuda.library()
    mults = probe_mults(*probe)
    ab_lines = ptxas_lines(built(ab_build[0], "local-stage A/B"), "k_ab_")
    log(f"build: kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    log(f"cluster kernels' registers and spills (ptxas -v, sm_90a; the "
        f"stage kernels and the encrypt transform): "
        f"{json.dumps(ptxas_report(ptxas))}")
    log(f"local-stage A/B probe (LOCAL_AB_SRC; k_ab_pair<0> the encrypt "
        f"transform's two inverses interleaved, <1> in turn), registers and "
        f"spills: {json.dumps(ab_lines)}")
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
            log(f"check {name} op (n = 2^15) {kname} J={J}: equal")
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
    cluster_checks(dev, rng, errs)
    encrypt_cluster_checks(dev, rng, errs)
    rule = {n: ntt_stage.cluster_size(n) for n in (2048, 4096, 16384, 32768)}
    log(f"stage kernels' cluster size B by the launchers' rule, by n (the "
        f"main paths' and the checks' transforms): {json.dumps(rule)}")
    for name in MULT_CHECK_SETS:
        ctx = BFVContext.build(get_bfv_params(name), device=dev)
        for kname, J, kern, plain, work in mult_cases(
                ctx, rng, dev, addneg=name != "32k_16q"):
            compare(kname, kern(), plain(), errs)
            log(f"check {name} {kname} J={J}: equal")
            if name == STAGE_SET and J == 1:
                timing[kname] = (kern, plain, work)
    timing30 = ntt30_checks(dev, rng, errs)
    r_ops = get_bfv_params(OPS_SET).r
    for kname, label, kern, plain, work in ops_cases(rng, dev):
        compare(kname, kern(), plain(), errs)
        log(f"check {kname} {label}: equal")
        if label in (OPS_SET, f"{OPS_SET} permuted B={2 * r_ops + 1} fwd"):
            timing[kname] = (kern, plain, work)
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
    c0g, c1g, skg = (torch.from_numpy(np.ascontiguousarray(a).view(
        np.int64)).to(dev) for a in (ct[0], ct[1], sk4))
    td4, dt4 = ctx4.tables_drop, ctx4.dec_tail_consts
    xg = ntt_stage.ntt_forward(c1g, td4)
    mg = bfv_tail.decrypt_fused(xg, skg, c0g, td4, dt4)
    compare("decrypt_fused", mg, bfv_tail.decrypt_fused_plain(
        xg, skg, c0g, td4, dt4), errs)
    if not np.array_equal(mg.cpu().numpy(), np.arange(ctx4.params.n) % 10):
        raise AssertionError("golden dec4k through kernel 15 != i % 10")
    log("golden: dec4k decrypts to i % 10 on the card, op and stage, and "
        "through kernel 15 (equal to its plain version)")

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

    # Phase 3b: the op-level entry points (kernels 12, 14, 15) on the
    # 32k_9q stage path's keys: encrypt and decrypt of its messages.
    ctx_o, res_o, msgs_o = paths["stage"]
    reset_counts()
    ops_res = drive_ops(ctx_o, res_o["pk"], res_o["sk"], msgs_o, dev)
    counts["ops"] = read_counts()
    for j in range(len(msgs_o)):
        if not torch.equal(ops_res["cts"][j], res_o["cts"][j]):
            raise AssertionError(f"ops path: encrypt_tail's ciphertext {j} "
                                 f"!= BFVContext.encrypt's")
        if not np.array_equal(ops_res["outs"][j].cpu().numpy(), msgs_o[j]):
            raise AssertionError(f"ops path: decrypt_fused(m{j}) != m{j}")
    if not torch.equal(ops_res["back"], ops_res["rows"]):
        raise AssertionError("ops path: the mod_idx inverse of the forward "
                             "!= its input")
    td_o, sk_o = ctx_o.tables_drop, res_o["sk"][:ctx_o.params.r - 1]
    for ct_j in ops_res["cts"]:
        x_j = ntt_stage.ntt_forward(ct_j[1].contiguous(), td_o)
        half = bfv_tail.decrypt_tail(ntt_stage.ntt_inverse_mul(
            x_j, sk_o, td_o), ct_j[0], ctx_o.dec_tail_consts)
        fused = bfv_tail.decrypt_fused(x_j, sk_o.contiguous(),
                                       ct_j[0].contiguous(), td_o,
                                       ctx_o.dec_tail_consts)
        if not torch.equal(fused, half):
            raise AssertionError("kernel 15 != BFVContext.decrypt's back "
                                 "half (kernel 8 + K2)")
    log(f"ops path {OPS_SET}: {len(msgs_o)} messages encrypted through "
        f"kernel 12 (mod_idx), kernel 8 and kernel 14 equal "
        f"BFVContext.encrypt's ciphertexts; decrypted through kernel 12 "
        f"and kernel 15 they round-trip; kernel 15 equals the decrypt's "
        f"back half (kernel 8 + K2); the mod_idx inverse over a permuted "
        f"index restores its input")
    log(f"launch counts in the ops run: {json.dumps(counts['ops'])}")
    missing = [k for k, (*_, s) in KERNELS.items()
               if "ops" in s and counts["ops"][k] < 1]
    if missing:
        raise AssertionError(f"kernels not launched on the ops path: "
                             f"{missing}")

    # Phase 3c: the coefficient-sharded transform (parallel/coef_kernels)
    # at C shards in one process, == kernels 7 and 8 on the whole.
    p_c = get_bfv_params(COEF_SET)
    coef_runs = {C: coef_path(p_c, C, rng, dev, errs) for C in COEF_CS}
    counts["coef"] = coef_runs[COEF_CS[0]]["counts"]
    for C, run in coef_runs.items():
        missing = [k for k, (*_, s) in KERNELS.items()
                   if "coef" in s and run["counts"][k] < 1]
        if missing:
            raise AssertionError(f"coef path C={C}: kernels not launched "
                                 f"{missing}")
        log(f"coef path {COEF_SET} C={C} (local n = {p_c.n // C}): every "
            f"shard's offset launch of kernels 7 and 8 equals the plain "
            f"local stages on its inputs; the forward and INTT(x . y), "
            f"shard by shard, equal the plain whole transforms and kernels "
            f"7 and 8 on the whole; every cross stage of either direction "
            f"equals its plain version; launch counts "
            f"{json.dumps(run['counts'])}")
    timing["coef_cross_stage"] = coef_runs[COEF_CS[0]]["cross"]

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
                if "mult" in s and (name == STAGE_SET
                                    or not {"op", "stage"} & set(s))]
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

    # Phase 11: the RNS-sharded program (parallel/spmd.py) at SPMD_SET.
    t0 = time.perf_counter()
    p_s = get_bfv_params(SPMD_SET)
    timing_spmd = {}
    # (a) kernels 16-18, and the sharded EvalMult's 20, 21a-c in band form
    # and 16's drop launch, == plain at the rank shapes
    for kname, label, kern, plain, work in (spmd_cases(p_s, dev, rng)
                                            + spmd_mult_cases(p_s, dev, rng)):
        compare(kname, kern(), plain(), errs)
        log(f"check SPMD {kname} {label}: equal")
        if label == f"{SPMD_SET} rows 0-{p_s.r}" + (
                " level 0" if kname == "decrypt_tail_partial" else ""):
            timing_spmd[kname] = (kern, plain, work)
        elif label == f"{SPMD_SET} rows 0-{p_s.r} drop":
            drop_case = (kern, plain, work)
    # (b) world size 1 over NCCL, the path through the public API
    multihost.initialize(free_address(), 1, 0)
    sctx = spmd.SpmdBFVContext.build(p_s)     # the default mesh and device
    if sctx.device != dev or sctx.shards != 1:
        raise AssertionError(f"SPMD: built on {sctx.device} over "
                             f"{sctx.shards} ranks")
    msgs_s = spmd_messages(p_s)
    ref_s = drive(ctx32, msgs_s, dev)          # BFVContext.build(params)
    ref_sw = ctx32.mod_switch_to_next(ref_s["cts"][0])
    torch.cuda.synchronize()
    reset_counts()
    res_s = drive_spmd(sctx, msgs_s)
    counts["spmd"] = read_counts()
    check_spmd(p_s, res_s["local"], res_s["collectives"], msgs_s, ref_s,
               ref_sw)
    log(f"SPMD {SPMD_SET} world size 1 (NCCL): {SPMD_MSGS} messages "
        f"round-trip, add / sub and the level-1 decrypt after "
        f"mod_switch_to_next too; keys and live ciphertext rows equal "
        f"BFVContext.build(params)'s; collectives per op "
        f"{json.dumps(res_s['collectives'])}")
    log(f"launch counts in the SPMD run: {json.dumps(counts['spmd'])}")
    missing = [k for k, (*_, s) in KERNELS.items()
               if "spmd" in s and counts["spmd"][k] < 1]
    if missing:
        raise AssertionError(f"kernels not launched on the SPMD path: "
                             f"{missing}")
    # (b') the sharded EvalMult at world size 1 on (b)'s keys and
    # ciphertexts, counts read as in 3
    mctx = spmd_mult.SpmdMultContext.build(sctx)
    ref_m = spmd_mult_reference(ctx32, ref_s)
    torch.cuda.synchronize()
    reset_counts()
    res_m = drive_spmd_mult(mctx, res_s)
    counts["spmd_mult"] = read_counts()
    check_spmd_mult(p_s, res_m["local"], res_m["collectives"], msgs_s, ref_m)
    log(f"SPMD EvalMult {SPMD_SET} world size 1 (NCCL): decrypt3 and the "
        f"relinearized decrypt equal the negacyclic m1 m2 mod t, "
        f"apply_galois({SPMD_GALOIS}) tau_g(m1); relin and Galois keys and "
        f"the live rows of mul, relinearize, mul with rlk and apply_galois "
        f"equal BFVContext.build(params)'s, mul's pad row 0; collectives "
        f"per op {json.dumps(res_m['collectives'])}")
    log(f"launch counts in the SPMD EvalMult run: "
        f"{json.dumps(counts['spmd_mult'])}")
    missing = [k for k, (*_, s) in KERNELS.items()
               if "spmd_mult" in s and counts["spmd_mult"][k] < 1]
    if missing:
        raise AssertionError(f"kernels not launched on the SPMD EvalMult "
                             f"path: {missing}")
    # (b'') the 2-D program (parallel/spmd2d.py) at world size 1 over NCCL,
    # its gloo meshes started first (their workers run beside (b'') and
    # (c))
    dirs2d = {m: tempfile.TemporaryDirectory() for m in SPMD2D_MESHES}
    procs2d = {m: start_spmd2d_ranks(*m, Path(dirs2d[m].name))
               for m in SPMD2D_MESHES}
    ctx2 = spmd2d.Spmd2DBFVContext.build(p_s)   # the default mesh, device
    if ctx2.device != dev or (ctx2.R, ctx2.C) != (1, 1):
        raise AssertionError(f"2-D: built on {ctx2.device} over "
                             f"{ctx2.R}x{ctx2.C}")
    reset_counts()
    res2 = drive_spmd2d(ctx2, msgs_s)
    counts["spmd2d"] = read_counts()
    check_spmd2d(p_s, res2["local"], res2["collectives"], 1, 1, msgs_s,
                 ref_s)
    log(f"2-D {SPMD_SET} world size 1 (NCCL, mesh (1, 1)): {SPMD_MSGS} "
        f"messages round-trip; keys and live ciphertext rows equal "
        f"BFVContext.build(params)'s; collectives per op "
        f"{json.dumps(res2['collectives'])}")
    log(f"launch counts in the 2-D run: {json.dumps(counts['spmd2d'])}")
    missing = [k for k, (*_, s) in KERNELS.items()
               if "spmd2d" in s and counts["spmd2d"][k] < 1]
    if missing:
        raise AssertionError(f"kernels not launched on the 2-D path: "
                             f"{missing}")
    # (c) SPMD_R processes on the one card over gloo == (b) and (b'), every
    # row
    r3 = run_spmd_ranks(SPMD_R)
    local3 = {k: v.to(dev) for k, v in r3["local"].items()}
    colls3 = r3["collectives"]
    check_spmd(p_s, local3, {k: colls3[k] for k in res_s["collectives"]},
               msgs_s, ref_s, ref_sw)
    check_spmd_mult(p_s, local3, {k: colls3[k] for k in res_m["collectives"]},
                    msgs_s, ref_m)
    ws1 = {**res_s["local"], **res_m["local"]}
    diff = [k for k, v in ws1.items() if not torch.equal(local3[k], v)]
    if diff or sorted(local3) != sorted(ws1):
        raise AssertionError(f"SPMD R={SPMD_R} != world size 1: {diff}")
    log(f"SPMD {SPMD_SET} R={SPMD_R} (gloo, {SPMD_R} processes on one "
        f"card, rl = {p_s.r // SPMD_R}): every tensor of the SPMD path and "
        f"the sharded EvalMult, padding rows included, equals the "
        f"world-size-1 run; collectives per op as there")
    # (c') the 2-D program's gloo meshes on the one card == (b'')
    for (R2, C2), procs in procs2d.items():
        got = finish_spmd2d_ranks(R2, C2, procs, Path(dirs2d[R2, C2].name))
        dirs2d[R2, C2].cleanup()
        local2 = {k: v.to(dev) for k, v in got["local"].items()}
        check_spmd2d(p_s, local2, got["collectives"], R2, C2, msgs_s, ref_s)
        diff = [k for k, v in res2["local"].items()
                if not torch.equal(local2[k], v)]
        if diff:
            raise AssertionError(f"2-D {R2}x{C2} != world size 1: {diff}")
        lacking = [k for k, (*_, s) in KERNELS.items()
                   if ("spmd2d" in s or k == "coef_cross_stage")
                   and min(c[k] for c in got["counts"]) < 1]
        if lacking:
            raise AssertionError(f"2-D {R2}x{C2}: kernels not launched on "
                                 f"every rank: {lacking}")
        log(f"2-D {SPMD_SET} {R2}x{C2} (gloo, {R2 * C2} processes on one "
            f"card, blocks ({p_s.r // R2}, {p_s.n // C2})): every tensor "
            f"equals the world-size-1 run, padding rows included; "
            f"collectives per op {json.dumps(got['collectives'])}; rank "
            f"0's launch counts {json.dumps(got['counts'][0])}")
    log(f"SPMD phase: {time.perf_counter() - t0:.1f} s")

    # Phase 12: times on the card.
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
    ds, dm = res_s["dtensor"], res_m["dtensor"]
    m_s = torch.from_numpy(msgs_s[0]).to(dev)
    single = (ref_s["sk"], ref_s["pk"], ref_s["cts"][0], ref_s["cts"][1],
              ref_m)
    spmd_keys = (ds["sk"], ds["pk"], ds["ct0"], ds["ct1"], dm)
    turns = {"stage": [], "op": [], "spmd": []}
    for which, c, cm, (sk_, pk_, ct_, ct1_, keys) in (
            ("stage", ctx32, ctx32, single), ("op", ctx_op32, ctx_op32, single),
            ("spmd", sctx, mctx, spmd_keys), ("spmd", sctx, mctx, spmd_keys),
            ("op", ctx_op32, ctx_op32, single),
            ("stage", ctx32, ctx32, single)):
        t = kge_times(c, sk_, pk_, ct_, m_s, 10)
        t.update(mult_turn_times(cm, ct_, ct1_, keys, 10))
        turns[which].append(t)
    log(f"SPMD world size 1 against BFVContext at {SPMD_SET} (ms, median of "
        f"CUDA-event timings around one call; turns stage, op, spmd, spmd, "
        f"op, stage; apply_galois of g = {SPMD_GALOIS}): "
        f"{json.dumps(turns)}")
    d2 = res2["dtensor"]
    turns2 = {"stage": [], "spmd": [], "spmd2d": []}
    for which, c, (sk_, pk_, ct_) in (
            ("stage", ctx32, single[:3]), ("spmd", sctx, spmd_keys[:3]),
            ("spmd2d", ctx2, (d2["sk"], d2["pk"], d2["ct0"])),
            ("spmd2d", ctx2, (d2["sk"], d2["pk"], d2["ct0"])),
            ("spmd", sctx, spmd_keys[:3]), ("stage", ctx32, single[:3])):
        turns2[which].append(kge_times(c, sk_, pk_, ct_, m_s, 10))
    log(f"2-D world size 1 against SpmdBFVContext and BFVContext at "
        f"{SPMD_SET} (ms, median of CUDA-event timings around one call; "
        f"turns stage, spmd, spmd2d, spmd2d, spmd, stage): "
        f"{json.dumps(turns2)}")
    td9, dt9 = ctx32.tables_drop, ctx32.dec_tail_consts
    r9 = ctx32.params.r
    x9, c09, c19 = (rand_res(rng, ctx32.params.q[:-1], ctx32.params.n, (),
                             dev) for _ in range(3))
    sk9 = ref_s["sk"][:r9 - 1].contiguous()
    back = {}
    for turn in range(2):
        for label, fn in (
                ("15", lambda: bfv_tail.decrypt_fused(x9, sk9, c09, td9,
                                                      dt9)),
                ("8 + K2", lambda: bfv_tail.decrypt_tail(
                    ntt_stage.ntt_inverse_mul(x9, sk9, td9), c09, dt9)),
                ("7 + 15", lambda: bfv_tail.decrypt_fused(
                    ntt_stage.ntt_forward(c19, td9), sk9, c09, td9, dt9)),
                ("K3 + K2", lambda: bfv_tail.decrypt_tail(
                    fused_ops.half_polymul(c19, sk9, td9), c09, dt9))):
            back.setdefault(label, []).append(kernel_ms(fn))
    log(f"decrypt back half at {SPMD_SET} (ms per call, CUDA events "
        f"around 20 calls, median of 3; two turns): kernel 15 against "
        f"kernel 8 + K2 (the stage schedule's), and kernel 7 + 15 against "
        f"K3 + K2 (the op schedule's, forward included): "
        f"{json.dumps(back)}")
    timing.update(timing_spmd)
    log(f"stage kernels' local stages, ntt_block.cuh's loop against the "
        f"register-tiled passes (device us per launch of P = 9 polynomials' "
        f"2^c blocks, torch.profiler; outputs equal): "
        f"{json.dumps(local_ab(ab_build[1], dev, rng))}")
    log(f"stage kernels at every cluster size B (device us per launch, "
        f"torch.profiler; ms per call of 20 back to back, CUDA events; "
        f"kernel 7 forward, kernel 8 inverse with y; outputs == plain): "
        f"{json.dumps(cluster_times(dev, rng, errs))}")
    log(f"K5 (transform and tail) and kernel 18 at every cluster size B "
        f"(device us per call, torch.profiler; ms per call of 20 back to "
        f"back, CUDA events; outputs == plain; transform_us: the transform "
        f"alone): {json.dumps(encrypt_cluster_times(dev, rng, errs))}")
    log(f"the encrypt transform's two local inverses at every cluster size "
        f"B (device us per launch, torch.profiler, in turns interleaved, in "
        f"turn, in turn, interleaved; both outputs == the one-array "
        f"inverse): {json.dumps(pair_ab(ab_build[1], dev, rng))}")
    bounds, terms = {}, {}
    for kname, (kern, plain, work) in timing.items():
        terms[kname] = work.terms(mults, clock_hz)
        bounds[kname] = (kernel_ms(kern), kernel_ms(plain),
                         *work.bound(mults, clock_hz))
    stage_dev = {k: device_us(timing[k][0]) for k in STAGE_ROWS}
    log(f"stage rows' device time at the timed shapes (us per call, "
        f"torch.profiler; 19: its three launches; 12: (19, n)): "
        f"{json.dumps(stage_dev)}")
    kern, plain, work = drop_case
    log(f"kernel 16 as the key switch's drop ({SPMD_SET}, (2, {p_s.r}, n)): "
        f"ms {kernel_ms(kern)}, plain ms {kernel_ms(plain)}, bound ms "
        f"{work.bound(mults, clock_hz)}")
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
    log(f"op kernels at {STAGE_SET} (n = 2^15: K3 and K4 two 2^14 halves, "
        f"K5 one cluster launch and its tail; J = 1, K5 also J = {BATCH_J}; "
        f"launches on the op32 path, K5 J = 16 on the batch path): "
        f"{json.dumps(op32)}")
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
    torch.distributed.destroy_process_group()
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--spmd-worker"]:
        spmd_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                    Path(sys.argv[5]))
        sys.exit(0)
    if sys.argv[1:2] == ["--spmd2d-worker"]:
        spmd2d_worker(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
                      sys.argv[5], Path(sys.argv[6]))
        sys.exit(0)
    sys.exit(main())
