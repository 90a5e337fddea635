"""Smoke run of the PyTorch/CUDA port (ntt_cuda_tpu_torch) on one card.

    python3 chip_smoke.py

Builds the CUDA kernels from ntt_cuda_tpu_torch/csrc with nvcc (sm_90a, one
nvcc per source, all started together) and, beside them, a probe whose
SASS gives the integer multiply instructions of one Shoup butterfly and
one Montgomery product (for each kernel's bound; K1's and 6's come from
the SASS of their own kernel, counted by pipe), a probe library that
runs the cluster kernels' local stages two ways (LOCAL_AB_SRC: the stage
kernels' loop against tiled passes, the encrypt transform's two inverses
interleaved against in turn).  Then:

1. every kernel exactly (tolerance 0) against its plain PyTorch version on
   the card: the keystream K1 at keygen's and encrypt's streams at 16k_5q
   and 32k_9q, at 32k_9q's relin_keygen stream, a Galois region (counter0
   past 2^32) and across the word-9 carry, kernel 6 at 32k_9q's encrypt
   stream, J = 1 and 16, each row also against K1; the op kernels K2-K5
   at 4k_3q and 16k_5q, K3-K5 also at
   32k_9q and 32k_16q (each transform one cluster launch, K5 then its
   tail), K3 (J = 1 and 3) and K4 at every cluster size B at 4k_3q, 16k_5q
   and 32k_9q (B = 1 at 2^15, whose n/B buffer does not fit a block,
   refused), K5 (J = 1 and 3) and kernel 18 at every B at 32k_9q and
   16k_5q (the B whose two n/B buffers do not fit a block, 1 at 2^14 and
   1, 2 at 2^15, refused), the stage
   kernels (7-10, 13) and the decrypt tail at 4k_3q, 16k_5q and 32k_9q
   (one cluster launch at 2^15), J = 1 and 3 where there is a batch axis,
   every stage row (7 both ways, 8-11, 12 both ways, 13's and 19/20's
   transforms, the coefficient shards' offset launches) also at cluster
   sizes B = 2, 4 and 8 at 32k_9q, the stage engine at the server cells'
   launch widths (each launch counted on the engine; its kernels' ptxas
   lines free of spills), K2 also at
   32k_16q; the EvalMult kernels (BEHZ
   21a-c, kernel 11, the key switch 19) at 4k_3q, 16k_5q and 32k_9q,
   21a-c and 19 also at 32k_16q, J = 1 and 2; 21a-c, the one-launch
   scale_and_round, their bands and K2 at 4k_3q, 16k_5q, 32k_9q and
   32k_16q, J = 1 and 2 (K2 1 and 3), each at the group size G (threads
   a coefficient) the launchers' rule takes there; kernel 22 (one cluster
   launch at every n) at n = 2^11, 2^14, 2^15 and 2^16, (1, 1, n) and
   (16, 1, n), int32 and int64, forward and inverse, by the rule and at
   every cluster size B (B = 1 at 2^16, whose n/B buffer does not fit a
   block, refused), and equal to the 64-bit plain transform on the same
   modulus;
2. the reference's golden ciphertext, on both schedules and through
   kernel 15 at every cluster size B;
3. the op schedule's main path at 16k_5q and the stage schedule's at
   32k_9q through the public API (keygen, encrypt of three seeded
   messages, decrypt, decrypt_batch; 32k_9q through
   `BFVContext.build(params)`, the default device and fusion), each with
   the launch counts set to 0 before it and read after it, its messages
   round-tripped and its keys and ciphertexts equal to the same calls on
   the CPU;
4. the EvalMult main path at 32k_9q through `BFVContext.build(params)`,
   at 16k_5q and at 32k_16q (k = 15; keygen, relin_keygen, encrypt of two seeded messages,
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
7. the op schedule at 32k_9q (`fusion="op"`: K3-K5 one cluster launch
   each), driven as in 3, its keys, ciphertexts and plaintexts equal to
   the stage schedule's;
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
   EvalMult's kernel 20, 21a-c in band form and kernel 16's drop launch
   (K5 at J = 16 also whole against its plain version in 12),
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
   kernel 22 at (16, 1, n), n = 2^15 and 2^16, both directions, also at
   every cluster size B; kernels 16-18, 20 and 21a-c's bands at 32k_9q's
   world-size-1 shapes, rl = 9; 16's drop launch logged beside); the
   stage rows', 14's and 15's device time (torch.profiler); the stage
   kernels' local stages, a one-stage loop against ntt_block.cuh's
   register-tiled passes, and kernels 7 and 8 at every
   cluster size B at n = 2^14 and 2^15 for P = 9, 18, 36 (device time and
   back-to-back CUDA events, each output held against its plain version);
   K5 at 16k_5q J = 1 and 32k_9q J = 1 and 16, and kernel 18 at 32k_9q, at
   every cluster size B, and the transform's two local inverses at those
   shapes interleaved (as the library runs them) and in turn, in turns;
   K3 (J = 1) and K4 at 16k_5q and 32k_9q at every B; the conversions,
   their bands and K2 at the group size G of the rule at the four sets
   beside each bound (scale_and_round also against 21b then 21c); every
   launch form of the encrypt tail (K5's and 13's at J = 1 and 16, 19's
   drop, 14, 16 and its drop at rows 0-9 and 6-9) and kernel 17 (rows 0-9
   and 6-9, levels 0 and 1) at 32k_9q through the library's C entry, each
   == plain, beside its bound; `ptxas -v` of every instantiation of the
   conversions, K2 / 17 and the encrypt tail; K1 and 6 at every shape of
   1 beside their bound, with `ptxas -v` of k_salsa20.  (The cluster
   kernels' __launch_bounds__ A/B is tools/bounds_ab.py, the keystream's
   design A/B tools/salsa_ab.py, each run on its own.)

13. kernels 12, 14 and 15 (the op-level entry points ntt_forward /
   ntt_inverse with mod_idx, encrypt_tail, decrypt_fused) against their
   plain versions: 12 over the standard and a permuted index (B = 2r + 1)
   at 4k_3q, 16k_5q and 32k_9q, both directions; 14 at 16k_5q and
   32k_9q; 15 (one cooperative cluster launch) at 16k_5q, 32k_9q and
   32k_16q by the rule and at every cluster size B (B = 1 at 2^15
   refused), and on the golden ciphertext; then the
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
   all-reduce), every gloo tensor equal to world size 1's; the 2-D
   EvalMult (parallel/spmd2d_mult.py: relin_keygen, mul, relinearize, mul
   with rlk, galois_keygen([3]), apply_galois, decrypt3) on those keys and
   ciphertexts at the same meshes, counts read as in 3, keys and live
   rows equal to BFVContext.build(params)'s, the products decrypting to
   m1 m2 mod t and the rotation to tau_3(m1), the collectives JAX's budget;
   kernel 20's launch on a coefficient shard (coef_kernels.
   local_keyswitch_acc) against its plain version at C = 1 (the (1, 1)
   mesh's shape), 2 and 4, every shard; and ShardedBFVContext (parallel/rns.py) at world size 1 over
   NCCL and over gloo on the one card at R = 3 (the SPMD programs) and
   R = 2 (`inner`; this script re-run as `--rns-worker`), the 16 methods
   of the JAX wrapper, every output equal to the same calls on
   BFVContext.build(params);
15. times: 12, 14, 15 and the cross-stage glue beside their bounds and
   plain versions; 15 beside kernel 8 + K2 (CUDA events and device time,
   in turns) and, forward included, 7 + 15 beside K3 + K2; 15 at every
   cluster size B at 16k_5q, 32k_9q and 32k_16q; 2-D keygen / encrypt /
   decrypt at world size 1 in turns beside SpmdBFVContext and BFVContext,
   and the 2-D mul, mul with rlk, relinearize and apply_galois beside
   BFVContext's; kernel 20's shard launch at (3, 2)'s rank shape (rows
   0-3, C = 2) beside its bound;
16. the op programs (BFVContext.op_programs / mult_program: keygen,
   encrypt, decrypt with the full and the dropped sk, encrypt_batch at J
   = 16, decrypt_batch at J = 3, mul + relin, square + relin) at 16k_5q
   (op) and 32k_9q (stage), each captured once as a CUDA graph
   (utils/profiling.graphed), counts read as in 3 over the captures: each
   replay equal to the eager public method bit for bit, and the replay of
   keygen, encrypt and encrypt_batch after a second nonce is copied into
   the static input equal to eager at that nonce; the draws'
   device-nonce keystream (kernel 6 at J = 1) equal to K1 at nonces 0, 1,
   2^62 + 9 and one with bit 63 set, through keygen's and encrypt's
   maps; eager and replay event ms, kernels a call, busy us and idle
   share; the chained slopes of keygen, encrypt and decrypt at 32k_9q
   (profiling.time_chained) and `python -m ntt_cuda_tpu_torch --params
   32k_9q demo --time`.

17. what the port refused until it took them (slice_phase): keygen with
   uniform_spec="fp64" at 16k_5q (op) and 32k_9q (stage), keys equal to
   the CPU plain path, the draw at the edge words equal to the host
   IEEE-double model, the keygen program replayed as a CUDA graph equal
   to eager; odd t >= 2^31 at 32k_9q's widths (nine 57-bit moduli, t =
   find_plain_modulus(32768, 33), and the largest batching t below
   2^62): K2, 15 (every B) and 17 against their plain versions (beside
   them at t = 65537, the Barrett strategy, for the times), the round
   trip, decrypt_batch, encrypt_batch of 16 and the batching encoder
   equal to the CPU plain path, EvalMult refused as the JAX package's
   aux base refuses it, and the RNS-sharded program at world size 1 over
   NCCL; n = 2^16 (r = 16) and 2^17 (r = 4): every stage row, K2-K5, 15,
   18 (K5 and 18 at B = 16 at 2^17, where B = 8 is refused), the
   EvalMult kernels and the bands at 2^16 (J = 1, 2) against their plain
   versions; keygen, encrypt, decrypt, encrypt_batch of 16 and mul +
   relin at 2^16 (keys and a ciphertext equal to the CPU plain path, the
   products to the exact negacyclic products), fusion="op" equal to
   stage there, a round trip and an encrypt_batch of 16 at 2^17, the
   coefficient-sharded transform with a 2^16 shard; counts read per
   path as in 3; the times of K2, 15, 17, kernels 7 and 8, K5 and 18 at
   these shapes beside their bounds, and fp64 keygen beside int.

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
                                    bfv_tail, fused_ops, modmath, ntt,
                                    ntt30, ntt_stage, poly, salsa20,
                                    sampling)
from ntt_cuda_tpu_torch.params import BFVParams, get_params  # noqa: E402
from ntt_cuda_tpu_torch.parallel import (mesh as pmesh,  # noqa: E402
                                         coef_kernels, multihost, rns,
                                         sharded, spmd, spmd2d, spmd2d_mult,
                                         spmd_mult)
from ntt_cuda_tpu_torch.models import encoder  # noqa: E402
from ntt_cuda_tpu_torch.utils import golden, primegen  # noqa: E402
from ntt_cuda_tpu_torch.utils import profiling, tracing  # noqa: E402
from ntt_cuda_tpu_torch.utils.profiling import median_ms  # noqa: E402

SEED = 20261016
OP_SET = "16k_5q"        # the op schedule's main path (n <= 16384)
STAGE_SET = "32k_9q"     # the stage schedule's main path (n = 32768)
# the EvalMult main path, timed at each (the CPU twin at OP_SET alone)
MULT_SETS = ("32k_9q", "16k_5q", "32k_16q")
OP_CHECK_SETS = ("4k_3q", "16k_5q")
STAGE_CHECK_SETS = ("4k_3q", "16k_5q", "32k_9q")
MULT_CHECK_SETS = ("4k_3q", "16k_5q", "32k_9q", "32k_16q")
OP32_CHECK_SETS = ("32k_9q", "32k_16q")   # K3-K5 at n = 2^15
OP32_KERNELS = ("half_polymul", "keygen_fused", "encrypt_fused")
BATCH_J = 16
NTT30_SIZES = (2048, 16384, 32768, 65536)   # kernel 22: one launch each
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
DEC_FUSED_SETS = ("16k_5q", "32k_9q", "32k_16q")  # kernel 15
COEF_SET, COEF_CS = "32k_9q", (2, 4)   # the coefficient-sharded transform
SPMD2D_MESHES = ((1, 2), (3, 2))       # (rns, coef) over gloo on one card
# kernel 20's shard launch (coef_kernels.local_keyswitch_acc) is held
# against its plain version at these (C, rows) rank shapes, every shard:
# the (1, 1), (1, 2) and (3, 2) meshes' and C = 4; timed at (3, 2)'s:
# rows 0-3, C = 2, shard 0
KSACC_CASES = ((1, (0, 9)), (2, (0, 9)), (2, (0, 3)), (2, (6, 9)),
               (4, (0, 9)), (4, (6, 9)))
# ShardedBFVContext (parallel/rns.py) over gloo on one card: R = 3 divides
# r = 9 (the SPMD programs), R = 2 does not (`inner`)
RNS_RS = (3, 2)
# the op programs (BFVContext.op_programs / mult_program) as CUDA graphs:
# the op schedule's set and the stage schedule's, full width
PROGRAM_SETS = ((OP_SET, "op"), (STAGE_SET, "stage"))
PROGRAM_DEC_J = 3
PROGRAM_NONCES = (5, 2**62 + 9)   # captured at the first, replayed at both
# the device-nonce keystream's nonce edges (bit 63 set in the last)
NONCE_EDGES = (0, 1, 2**62 + 9, 2**63 + 7)
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
# K3 and K4 (csrc/fused_ops.cu, one n/B buffer a block): held against their
# plain versions at every B at these sets (K3 at J = 1 and 3), and timed at
# every B a launch takes at these (J = 1)
OPC_CHECK_SETS = ("4k_3q", "16k_5q", "32k_9q")
OPC_TIME_SETS = ("16k_5q", "32k_9q")
# the rows that run the stage kernels, as timed (12 at (19, n), 13 with its
# tail launch, 19 its three launches, 20 at rl = 9)
# the rows whose device time (torch.profiler) is logged beside their times
DEVICE_ROWS = ("ntt_forward", "ntt_inverse", "ntt_inverse_mul",
               "ntt_forward_ternary", "ntt_forward_addneg_gauss",
               "ntt_forward_addneg", "ntt_transform_idx",
               "encrypt_fused_stage", "keyswitch_fused", "keyswitch_front",
               "encrypt_tail", "decrypt_fused", "coef_cross_stage",
               "keyswitch_acc_shard")
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
# per SM per clock, compute capability 9.0 (the CUDA C++ Programming
# Guide's arithmetic instruction throughput table): 64 results of 32-bit
# integer multiply-add on the FMA pipe, and 64 of 32-bit integer add,
# bitwise operation and shift on the integer ALU pipe
SMS, IMAD_PER_CLOCK, ALU_PER_CLOCK = 132, 64, 64
# K1 and 6 (csrc/salsa20.cu): their bound counts the SASS of k_salsa20,
# one thread a 64-byte block, by pipe (sass_pipes); the four-lane form
# that small launches take (k_salsa20_lanes) issues more for the same work
SALSA_KERNEL, SALSA_LANES_KERNEL = "k_salsa20", "k_salsa20_lanes"
SALSA_SETS = ("16k_5q", "32k_9q")
SALSA_CARRY = 2**32 - 5       # counter0 whose blocks cross into word 9
# k_salsa20_draws (kernel 6 fused with the encryption draws' converters) at
# the client cells' shapes, (set, J), and at J = 1; its bound's instruction
# term is K1's rounds a block (k_salsa20's SASS) and, a Gaussian word, the
# least a six-step search issues: a compare and an add a step
DRAWS_SHAPES = (("16k_5q", 32), ("32k_9q", 16), ("16k_5q", 1))
DRAWS_KERNEL = "k_salsa20_draws"
GAUSS_SEARCH_ALU = 2 * 6

# name -> (its wrappers' names in utils/tracing.WRAPPERS, CUDA source, the
# TPU kernel it replaces, the main paths that run it; its launches, counted
# by the registry, are the first path's: the EvalMult path's wherever it
# runs the kernel, 0 where no path does)
KERNELS = {
    "salsa20_keystream": (("salsa20.keystream_words",),
                          "ntt_cuda_tpu_torch/csrc/salsa20.cu",
                          "ntt_cuda_tpu/ops/salsa20.py:174",
                          ("mult", "op", "stage", "op32", "spmd", "spmd_mult",
                           "spmd2d", "spmd2d_mult", "rns", "rns_inner", "fp64",
                           "wide_t", "large_n", "large_n17")),
    "salsa20_keystream_batch": (("salsa20.keystream_words_batch",),
                                "ntt_cuda_tpu_torch/csrc/salsa20.cu",
                                "ntt_cuda_tpu/ops/salsa20.py:249",
                                ("programs",)),
    # kernel 6 and the converters of encrypt_batch's draws in one kernel
    "salsa20_draws": (("salsa20.encrypt_draws_batch",),
                      "ntt_cuda_tpu_torch/csrc/salsa20.cu",
                      "ntt_cuda_tpu/ops/salsa20.py:249 + ops/sampling.py "
                      "ternary_int, gaussian_int",
                      ("batch", "rns", "rns_inner", "programs", "wide_t",
                       "large_n", "large_n17")),
    "decrypt_tail": (("bfv_tail.decrypt_tail",),
                     "ntt_cuda_tpu_torch/csrc/decrypt_tail.cu",
                     "ntt_cuda_tpu/ops/bfv_tail.py:388",
                     ("mult", "op", "stage", "batch", "op32", "rns_inner",
                      "programs", "wide_t", "large_n", "large_n17")),
    "half_polymul": (("fused_ops.half_polymul",),
                     "ntt_cuda_tpu_torch/csrc/fused_ops.cu",
                     "ntt_cuda_tpu/ops/fused_ops.py:213",
                     ("op", "op32", "spmd", "spmd_mult", "rns", "programs")),
    "keygen_fused": (("fused_ops.keygen_fused",),
                     "ntt_cuda_tpu_torch/csrc/fused_ops.cu",
                     "ntt_cuda_tpu/ops/fused_ops.py:137",
                     ("op", "op32", "spmd", "programs", "fp64")),
    "encrypt_fused": (("fused_ops.encrypt_fused",),
                      "ntt_cuda_tpu_torch/csrc/fused_ops.cu",
                      "ntt_cuda_tpu/ops/fused_ops.py:466",
                      ("op", "batch", "op32", "rns", "rns_inner", "programs",
                       "wide_t", "large_n", "large_n17")),
    # kernel 7, both directions (one TPU kernel with an `inverse` flag);
    # its times below are the forward's, the direction the main path runs
    # (also its shard-offset launch, coef_kernels.local_forward, on the
    # 2-D program's path)
    "ntt_transform": (("ntt_stage.ntt_forward", "ntt_stage.ntt_inverse",
                       "coef_kernels.local_forward"),
                      "ntt_cuda_tpu_torch/csrc/ntt_stage.cu",
                      "ntt_cuda_tpu/ops/ntt_pallas.py:558",
                      ("mult", "stage", "spmd_mult", "spmd2d", "coef",
                       "spmd2d_mult", "rns", "rns_inner", "programs", "wide_t",
                       "large_n", "large_n17")),
    "ntt_inverse_mul": (("ntt_stage.ntt_inverse_mul",
                         "coef_kernels.local_inverse_mul"),
                        "ntt_cuda_tpu_torch/csrc/ntt_stage.cu",
                        "ntt_cuda_tpu/ops/ntt_pallas.py:685",
                        ("mult", "stage", "spmd_mult", "spmd2d", "coef",
                         "spmd2d_mult", "rns", "rns_inner", "programs", "fp64",
                         "wide_t", "large_n", "large_n17")),
    "ntt_forward_ternary": (("ntt_stage.ntt_forward_ternary",),
                            "ntt_cuda_tpu_torch/csrc/ntt_stage.cu",
                            "ntt_cuda_tpu/ops/ntt_pallas.py:782",
                            ("mult", "stage", "rns", "rns_inner", "programs",
                             "fp64", "wide_t", "large_n", "large_n17")),
    "ntt_forward_addneg_gauss": (("ntt_stage.ntt_forward_addneg_gauss",),
                                 "ntt_cuda_tpu_torch/csrc/ntt_stage.cu",
                                 "ntt_cuda_tpu/ops/ntt_pallas.py:959",
                                 ("mult", "stage", "rns", "rns_inner",
                                  "programs", "fp64", "wide_t", "large_n",
                                  "large_n17")),
    "encrypt_fused_stage": (("bfv_tail.encrypt_fused",),
                            "ntt_cuda_tpu_torch/csrc/ntt_stage.cu",
                            "ntt_cuda_tpu/ops/bfv_tail.py:661",
                            ("mult", "stage", "rns", "rns_inner", "programs",
                             "wide_t", "large_n", "large_n17")),
    "ntt_forward_addneg": (("ntt_stage.ntt_forward_addneg",),
                           "ntt_cuda_tpu_torch/csrc/ntt_stage.cu",
                           "ntt_cuda_tpu/ops/ntt_pallas.py:868",
                           ("mult", "spmd_mult", "rns", "rns_inner",
                            "large_n")),
    # three launches: two of ntt_stage.cu and fused_ops.cu's tail
    "keyswitch_fused": (("fused_ops.keyswitch_fused",),
                        "ntt_cuda_tpu_torch/csrc/ntt_stage.cu",
                        "ntt_cuda_tpu/ops/fused_ops.py:651",
                        ("mult", "rns_inner", "programs", "large_n")),
    "behz_rns_to_bsk": (("behz_kernels.rns_to_bsk",),
                        "ntt_cuda_tpu_torch/csrc/behz.cu",
                        "ntt_cuda_tpu/ops/behz_pallas.py:183",
                        ("mult", "rns_inner", "programs", "large_n")),
    # 21b and 21c alone: no main path launches them (mul and square run
    # both bodies in one launch, scale_and_round, the next row; the
    # sharded EvalMult their band form, the rows below), so their
    # launches are 0
    "behz_fast_floor": (("behz_kernels.fast_floor",),
                        "ntt_cuda_tpu_torch/csrc/behz.cu",
                        "ntt_cuda_tpu/ops/behz_pallas.py:227", ()),
    "behz_bsk_to_q": (("behz_kernels.bsk_to_q",),
                      "ntt_cuda_tpu_torch/csrc/behz.cu",
                      "ntt_cuda_tpu/ops/behz_pallas.py:258", ()),
    "behz_scale_and_round": (("behz_kernels.scale_and_round",),
                             "ntt_cuda_tpu_torch/csrc/behz.cu",
                             "ntt_cuda_tpu/ops/behz_pallas.py:406",
                             ("mult", "rns_inner", "programs", "large_n")),
    # kernel 22, both directions; its times below are the forward's at
    # (16, 1, 65536)
    "ntt30_transform": (("ntt30.ntt_forward", "ntt30.ntt_inverse"),
                        "ntt_cuda_tpu_torch/csrc/ntt30.cu",
                        "ntt_cuda_tpu/ops/ntt_pallas30.py:257", ("cli30",)),
    # the RNS-sharded program's kernels (parallel/spmd.py): 18, 16, 17
    "encrypt_front": (("fused_ops.encrypt_front",),
                      "ntt_cuda_tpu_torch/csrc/fused_ops.cu",
                      "ntt_cuda_tpu/ops/fused_ops.py:301",
                      ("spmd", "wide_t_spmd")),
    # 16 also as the sharded key switch's modulus drop (no e, no message)
    "encrypt_tail_padded": (("bfv_tail.encrypt_tail_padded",
                             "bfv_tail.drop_last_padded"),
                            "ntt_cuda_tpu_torch/csrc/fused_ops.cu",
                            "ntt_cuda_tpu/ops/bfv_tail.py:760",
                            ("spmd", "spmd_mult", "spmd2d", "spmd2d_mult",
                             "rns", "wide_t_spmd")),
    "decrypt_tail_partial": (("bfv_tail.decrypt_tail_partial",),
                             "ntt_cuda_tpu_torch/csrc/decrypt_tail.cu",
                             "ntt_cuda_tpu/ops/bfv_tail.py:886",
                             ("spmd", "spmd_mult", "spmd2d", "spmd2d_mult",
                              "rns", "wide_t_spmd")),
    # the sharded EvalMult's kernels (parallel/spmd_mult.py): 20 (kernel
    # 19's two transform launches over a rank's rows) and 21a-c in band form
    "keyswitch_front": (("fused_ops.keyswitch_front",),
                        "ntt_cuda_tpu_torch/csrc/ntt_stage.cu",
                        "ntt_cuda_tpu/ops/fused_ops.py:766",
                        ("spmd_mult", "rns")),
    # kernel 20's accumulate-and-inverse launch on a coefficient shard
    # (coef_kernels.local_keyswitch_acc: PRO_KSACC with the shard offset),
    # the 2-D key switch's (parallel/spmd2d_mult.py)
    "keyswitch_acc_shard": (("coef_kernels.local_keyswitch_acc",),
                            "ntt_cuda_tpu_torch/csrc/ntt_stage.cu",
                            "ntt_cuda_tpu/ops/fused_ops.py:766",
                            ("spmd2d_mult",)),
    "behz_rns_to_bsk_rows": (("behz_kernels.rns_to_bsk_rows",),
                             "ntt_cuda_tpu_torch/csrc/behz.cu",
                             "ntt_cuda_tpu/ops/behz_pallas.py:431",
                             ("spmd_mult", "spmd2d_mult", "rns")),
    "behz_fast_floor_rows": (("behz_kernels.fast_floor_rows",),
                             "ntt_cuda_tpu_torch/csrc/behz.cu",
                             "ntt_cuda_tpu/ops/behz_pallas.py:447",
                             ("spmd_mult", "spmd2d_mult", "rns")),
    "behz_bsk_to_q_rows": (("behz_kernels.bsk_to_q_rows",),
                           "ntt_cuda_tpu_torch/csrc/behz.cu",
                           "ntt_cuda_tpu/ops/behz_pallas.py:464",
                           ("spmd_mult", "spmd2d_mult", "rns")),
    # the op-level entry points (the ops path): 12 (ntt_forward /
    # ntt_inverse with mod_idx), 14 (encrypt_tail), 15 (decrypt_fused)
    "ntt_transform_idx": (("ntt_stage.ntt_transform_idx",),
                          "ntt_cuda_tpu_torch/csrc/ntt_stage.cu",
                          "ntt_cuda_tpu/ops/ntt_pallas.py:496", ("ops",)),
    "encrypt_tail": (("bfv_tail.encrypt_tail",),
                     "ntt_cuda_tpu_torch/csrc/fused_ops.cu",
                     "ntt_cuda_tpu/ops/bfv_tail.py:144", ("ops",)),
    "decrypt_fused": (("bfv_tail.decrypt_fused",),
                      "ntt_cuda_tpu_torch/csrc/ntt_stage.cu",
                      "ntt_cuda_tpu/ops/bfv_tail.py:507", ("ops",)),
    # glue of the coefficient-sharded transform, not a TPU kernel: the
    # cross-shard butterfly, XLA in the JAX package (parallel/sharded.py
    # _cross_forward_stage); its launches are the one-process coef path's
    "coef_cross_stage": (("coef_kernels.cross_stage",),
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
extern "C" __global__ void probe_mul128(const u64* a, u64* o) {
  const unsigned __int128 p = (unsigned __int128)a[0] * a[1];
  o[0] = (u64)p;
  o[1] = (u64)(p >> 64);
}
"""


# The local stages of the cluster kernels two ways, on P 2^c blocks of
# 2^(logn - c) points each (block b: piece b % 2^c of polynomial b >> c,
# the cluster schedule's tw_mul = 2^c + piece over the full tables).
# k_ab_local: V = 0 the one-stage loop below (one block barrier and one
# shared-memory round trip a stage), V = 2 or 3 ntt_block.cuh's
# register-tiled passes of V stages.  k_ab_pair: the encrypt transform's local inverse stages of its
# two products (fused_ops.cu's phase B), two buffers a block, T = 0
# interleaved in one tiled pass (each twiddle load serving both, as the
# library does), T = 1 one tiled inverse after the other.
LOCAL_AB_SRC = r"""
#include "ntt_cluster.cuh"
// One stage a step: CT forward / GS inverse (no n^-1) of s[0, 2^logn),
// twiddle tw_mul len + ps, butterflies g = tid, tid + nt, ...
template <bool INV>
__device__ void loop_stages(u64* s, int logn, const Twiddles& tw, u64 q,
                            int tid, int nt, int tw_mul) {
  __syncthreads();
  for (int st = 0; st < logn; ++st) {
    const int lg = INV ? logn - 1 - st : st;
    const int sl = logn - 1 - lg, step = 1 << sl, len = 1 << lg;
    for (int g = tid; g < (1 << (logn - 1)); g += nt) {
      const int ps = g >> sl;
      const int tgt = (ps << (sl + 1)) | (g & (step - 1));
      const int w = tw_mul * len + ps;
      if (INV) gs_butterfly(s[tgt], s[tgt + step], tw.ipsi[w], tw.ipsi_sh[w], q);
      else ct_butterfly(s[tgt], s[tgt + step], tw.psi[w], tw.psi_sh[w], q);
    }
    __syncthreads();
  }
}
static cudaError_t smem_limit(const void* kern) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)(sizeof(u64) << LOG_BLOCK_MAX));
}
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
    if (inverse) loop_stages<true>(s, logb, t, k.q, tid, nt, m);
    else loop_stages<false>(s, logb, t, k.q, tid, nt, m);
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
  const int threads = v == 0 ? (nb / 2 < 1024 ? nb / 2 : 1024)
                      : v == 2 ? tiled_threads<2>(nb) : tiled_threads<3>(nb);
  const cudaError_t e = smem_limit((const void*)kern);
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
  const cudaError_t e = smem_limit((const void*)kern);
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
    """ntt_stage.cu, fused_ops.cu, ntt30.cu, behz.cu, decrypt_tail.cu and
    salsa20.cu compiled once more with `-Xptxas -v` (registers, spills and
    stack of each kernel), beside the library's build; salsa20.o's SASS
    gives K1's and 6's instructions (sass_pipes)."""
    out = ROOT / "build" / "ptxas"
    out.mkdir(parents=True, exist_ok=True)
    return [subprocess.Popen(
        [cuda.find_nvcc(), *cuda.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
         str(out / f"{src}.o"), str(cuda.CSRC / f"{src}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src in ("ntt_stage", "fused_ops", "ntt30", "behz",
                    "decrypt_tail", "salsa20")]


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


# the cluster kernels' names, and the conversion kernels' and K2's
CLUSTER_KERNELS = "k_stage_|k_op_cluster|k_decrypt_cluster|k_ntt30_cluster"
# the stage engine's kernels: k_stage_*<3, 2, PRO> (PRO >= 0)
ENGINE_KERNELS = r"k_stage_\w+ILi3ELi2ELi\d"
GROUP_KERNELS = "k_behz|k_decrypt_tail|k_encrypt_tail"


# SASS opcodes by the pipe that issues them: the FMA pipe's integer
# multiply-adds (every IMAD form, also the .MOV / .SHL / .IADD ones nvcc
# emits for moves, shifts and adds) and the integer ALU pipe's forms; the
# rest (memory, control, the uniform datapath's U* forms) is neither
FMA_OPS = ("IMAD", "IMUL")
ALU_OPS = ("LOP3", "SHF", "IADD3", "LEA", "ISETP", "SEL", "PRMT", "MOV",
           "SHL", "SHR", "IABS", "IMNMX", "PLOP3")


def mangled_is(fn: str, kernel: str) -> bool:
    """Whether the mangled function name `fn` is the kernel `kernel`: its
    name, with a template's mangled arguments where it has them (e.g.
    k_ab_salsaILi0ELi0ELi10E)."""
    m = re.match(r"_Z(\d+)", fn)
    if not m:
        return False
    name = fn[m.end():m.end() + int(m.group(1))]
    return (name == kernel or kernel.startswith(name + "I")
            and fn[m.end():].startswith(kernel))


def sass_pipes(obj: Path, kernel: str) -> dict:
    """The instructions of `kernel` in the SASS of a built object
    (cuobjdump -sass), by pipe: `fma`, `alu`, `other`, and `ops` the
    opcode histogram.  Straight-line code (K1's rounds are fully unrolled),
    so these are the instructions a thread issues."""
    cuobjdump = Path(cuda.find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(obj)],
                          capture_output=True, text=True, check=True).stdout
    ops, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m and fn and mangled_is(fn, kernel):
            ops[m.group(1)] = ops.get(m.group(1), 0) + 1
    if not ops:
        raise RuntimeError(f"SASS of {obj.name}: no function {kernel}")
    res = {"fma": 0, "alu": 0, "other": 0}
    for op, cnt in ops.items():
        base = op.split(".")[0]
        pipe = ("fma" if base in FMA_OPS else "alu" if base in ALU_OPS
                else "other")
        res[pipe] += cnt
    return {**res, "ops": ops}


def ptxas_report(procs: list[subprocess.Popen]) -> str:
    return "\n".join(built(proc, "ptxas report") for proc in procs)


def spills(lines: dict[str, str]) -> dict[str, str]:
    """The kernels whose ptxas lines report spill stores or loads."""
    return {k: v for k, v in lines.items()
            if re.search(r"[1-9]\d* bytes spill", v)}


def device_us(fn, reps: int = 20, names: set | None = None,
              every: bool = False) -> float:
    """Device time of one call in us: torch.profiler's intervals of the
    port's kernels (k_*; with `every`, of every device event, PyTorch's
    own kernels and copies too) over a window of calls, summed, over the
    calls; their names go into `names` where it is given.  A window now
    and then records no device event at all, and has done so three times
    in a row: up to eight windows are tried, each after an empty one twice
    as long (up to 16 `reps`), and the empty ones are logged."""
    fn()
    torch.cuda.synchronize()
    for attempt in range(8):
        calls = reps << min(attempt, 4)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        dev_events = [e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA]
        iv = [e.time_range.end - e.time_range.start for e in dev_events
              if every or e.name.removeprefix("void ").startswith("k_")]
        if dev_events:
            break
        log(f"device_us: a profiler window of {calls} calls recorded no "
            f"device event; trying again")
    if not iv:
        raise RuntimeError(f"torch.profiler saw no kernel of the port on the "
                           f"device (device events: "
                           f"{sorted({e.name for e in dev_events})[:8]})")
    if names is not None:
        names.update(e.name for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and e.name.removeprefix("void ").startswith("k_"))
    return sum(iv) / calls


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
    if sorted(counts) != ["mod_nu", "mont", "mul128", "mul32", "mullo",
                          "shoup", "shoup32"]:
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
    written once) and the instructions it must issue, in units of the
    probed primitives: `shoup`, `mont`, `mod_nu`, `mullo`, `mul32`,
    `shoup32`, `mul128` (a 64 x 64 -> 128-bit product), whose integer
    multiplies run on the FMA pipe, and `salsa20_block` (a 64-byte block of
    K1 and 6, whose SASS is counted by pipe)."""

    def __init__(self, nbytes: int, **prims):
        self.nbytes, self.prims = nbytes, prims

    def terms(self, mults: dict, clock_hz: float) -> dict:
        """The two times, in ms, whose larger is the bound: the bytes, and
        the instructions of the busier pipe (FMA or ALU) at its rate."""
        pipes = {"fma": 0, "alu": 0}
        for k, v in self.prims.items():
            m = mults[k]
            for pipe, cnt in (m.items() if isinstance(m, dict)
                              else [("fma", m)]):
                if pipe in pipes:
                    pipes[pipe] += cnt * v
        clocks = max(pipes["fma"] / IMAD_PER_CLOCK,
                     pipes["alu"] / ALU_PER_CLOCK)
        return {"bytes": self.nbytes, "imads": pipes["fma"],
                "alu": pipes["alu"],
                "bytes_ms": self.nbytes / HBM_BYTES_PER_S * 1e3,
                "ops_ms": clocks / (SMS * clock_hz) * 1e3}

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


def blocks(nbytes: int) -> int:
    return -(-nbytes // 64)


def keystream_shapes() -> list:
    """(kernel, label, blocks, keyword arguments) of K1 and 6 at the shapes
    the main paths give them: K1 at keygen's and encrypt's streams at
    SALSA_SETS, at 32k_9q's relin_keygen stream (k = r - 1 keys) and a
    Galois region (element 2n - 1, counter0 = (2n - 1) region, past 2^32),
    and at encrypt's and keygen's sizes across the word-9 carry (the
    launcher's two forms); kernel 6 at encrypt's stream for the mapped
    nonces of 1..J, J = 1 and BATCH_J."""
    shapes = []
    for name in SALSA_SETS:
        p = get_bfv_params(name)
        shapes += [
            ("salsa20_keystream", f"keygen {name}",
             blocks(sampling.keygen_entropy_bytes(p.n, p.r)),
             dict(nonce=sampling.keygen_nonce(1))),
            ("salsa20_keystream", f"encrypt {name}",
             blocks(sampling.encrypt_entropy_bytes(p.n)),
             dict(nonce=sampling.encrypt_nonce(1)))]
    p = get_bfv_params(STAGE_SET)
    region = blocks(sampling.relin_entropy_bytes(p.n, p.r, p.r - 1))
    g = 2 * p.n - 1
    enc = blocks(sampling.encrypt_entropy_bytes(p.n))
    kg = blocks(sampling.keygen_entropy_bytes(p.n, p.r))
    shapes += [
        ("salsa20_keystream", f"relin_keygen {STAGE_SET}", region,
         dict(key_byte=sampling.RELIN_KEY_BYTE, nonce=1)),
        ("salsa20_keystream", f"galois {STAGE_SET} element {g}", region,
         dict(key_byte=sampling.GALOIS_KEY_BYTE, nonce=1,
              counter0=g * region)),
        ("salsa20_keystream", f"encrypt {STAGE_SET} counter0 2^32-5", enc,
         dict(nonce=3, counter0=SALSA_CARRY)),
        ("salsa20_keystream", f"keygen {STAGE_SET} counter0 2^32-5", kg,
         dict(nonce=3, counter0=SALSA_CARRY))]
    for J in (1, BATCH_J):
        shapes.append(("salsa20_keystream_batch", f"J={J} {STAGE_SET}", enc,
                       dict(nonces=sampling.encrypt_nonces(range(1, J + 1)))))
    return shapes


def keystream_cases(dev) -> list:
    """(kernel, label, wrapper call, plain call, Work) at keystream_shapes:
    64 bytes written a block (and 6's nonces read), one salsa20_block of
    instructions."""
    cases = []
    for kname, label, nb, kw in keystream_shapes():
        batch = "nonces" in kw
        J = len(kw["nonces"]) if batch else 1
        kern, plain = ((salsa20.keystream_words_batch,
                        salsa20.keystream_words_batch_plain) if batch else
                       (salsa20.keystream_words, salsa20.keystream_words_plain))
        cases.append((kname, label,
                      lambda f=kern, nb=nb, kw=kw: f(nb, device=dev, **kw),
                      lambda f=plain, nb=nb, kw=kw: f(nb, device=dev, **kw),
                      Work(64 * J * nb + 8 * J * batch,
                           salsa20_block=J * nb)))
    return cases


def keystream_checks(dev, errs: dict) -> dict:
    """K1 and 6 exactly against their plain versions at keystream_cases'
    shapes, each row of 6 also against K1's stream of its nonce; returns
    the cases by label."""
    cases = keystream_cases(dev)
    for kname, label, kern, plain, _ in cases:
        got = kern()
        compare(kname, got, plain(), errs)
        if kname == "salsa20_keystream_batch":
            J = got.shape[0]
            for j, nonce in enumerate(sampling.encrypt_nonces(
                    range(1, J + 1))):
                compare(kname, got[j], salsa20.keystream_words(
                    got.shape[1] // 16, nonce=int(nonce), device=dev), errs)
        log(f"check {kname} {label}: equal"
            + (", each row equal to K1's stream of its nonce"
               if kname == "salsa20_keystream_batch" else ""))
    return {c[1]: c for c in cases}


def keystream_times(cases: dict, mults: dict, clock_hz: float) -> dict:
    """Device us per call of K1 and 6 (torch.profiler, two windows of 10
    calls) at keystream_cases' shapes, beside the bound: the bytes written
    over 3.35 TB/s, or the busier pipe's SASS instructions over its rate."""
    res = {}
    for label, (kname, _, kern, _, work) in cases.items():
        bound_ms, bound_by = work.bound(mults, clock_hz)
        t = work.terms(mults, clock_hz)
        res[f"{kname} {label}"] = {
            "us": [device_us(kern, 10) for _ in range(2)],
            "bound_us": bound_ms * 1e3, "bound_by": bound_by,
            "bytes_us": t["bytes_ms"] * 1e3, "ops_us": t["ops_ms"] * 1e3,
            "alu": t["alu"], "fma": t["imads"]}
    return res


def draws_ref(n: int, nonces, dev):
    """encrypt_batch's draws as they were before k_salsa20_draws: kernel
    6's streams of the mapped nonces, then the plain converters on the
    card."""
    ks = salsa20.keystream_words_batch(
        blocks(sampling.encrypt_entropy_bytes(n)),
        sampling.encrypt_nonces(nonces), device=dev)
    return (sampling.ternary_int(salsa20.bytes_u8(ks, 0, n)),
            sampling.gaussian_int(salsa20.bytes_u32(ks, n, 2 * n).reshape(
                -1, 2, n)))


def draws_cases(dev) -> dict:
    """label -> (kernel, wrapper call, plain call, Work, n, nonces) of
    k_salsa20_draws at DRAWS_SHAPES, nonces 0, one with bits 32-62 set,
    then 1, 2, ...: 12 bytes written a coefficient (u_b's int32 and e_d's
    two) and the nonces read; K1's rounds a block and a search a Gaussian
    word."""
    cases = {}
    for name, J in DRAWS_SHAPES:
        n = get_bfv_params(name).n
        nonces = ([0, 0x7FFFFFFF00000000 | 5] + list(range(1, J - 1)))[:J]
        cases[f"{name} J={J}"] = (
            "salsa20_draws",
            lambda n=n, v=nonces: salsa20.encrypt_draws_batch(n, v,
                                                              device=dev),
            lambda n=n, v=nonces: draws_ref(n, v, dev),
            Work(12 * J * n + 8 * J,
                 salsa20_block=J * blocks(sampling.encrypt_entropy_bytes(n)),
                 gauss_search=2 * J * n), n, nonces)
    return cases


def draws_checks(dev, errs: dict) -> dict:
    """k_salsa20_draws exactly against kernel 6 and the plain converters at
    DRAWS_SHAPES; one launch a call, through encrypt_draws_compact_batch
    too; returns the cases."""
    cases = draws_cases(dev)
    for label, (kname, kern, plain, _, n, nonces) in cases.items():
        want = plain()
        compare(kname, kern(), want, errs)
        torch.cuda.synchronize()
        reset_counts()
        got = sampling.encrypt_draws_compact_batch(n, nonces, device=dev)
        launched = read_counts()
        compare(kname, got, want, errs)
        if launched["salsa20_draws"] != 1 or sum(launched.values()) != 1:
            raise AssertionError(f"draws {label}: launches {launched}, "
                                 f"expected one of k_salsa20_draws alone")
        log(f"check {kname} {label}: equal to kernel 6's streams and the "
            f"plain converters on the card; encrypt_draws_compact_batch one "
            f"launch of it")
    return cases


def draws_times(cases: dict, mults: dict, clock_hz: float) -> dict:
    """Device us per call of k_salsa20_draws (torch.profiler, two windows
    of 10 calls) at DRAWS_SHAPES beside the bound, and of the path it
    replaced (kernel 6, then the plain converters: every device event)."""
    res = {}
    for label, (kname, kern, plain, work, *_) in cases.items():
        bound_ms, bound_by = work.bound(mults, clock_hz)
        t = work.terms(mults, clock_hz)
        res[f"{kname} {label}"] = {
            "us": [device_us(kern, 10) for _ in range(2)],
            "kernel6_and_converters_us": [device_us(plain, 10, every=True)
                                          for _ in range(2)],
            "ms": kernel_ms(kern), "kernel6_and_converters_ms":
                kernel_ms(plain),
            "bound_us": bound_ms * 1e3, "bound_by": bound_by,
            "bytes_us": t["bytes_ms"] * 1e3, "ops_us": t["ops_ms"] * 1e3,
            "alu": t["alu"], "fma": t["imads"]}
    return res


def op_cases(ctx: BFVContext, rng, dev):
    """(kernel, J, wrapper call, plain call, Work) for K2-K5 at the shapes
    the op schedule's main path gives each, J = 1 and 3 where a batch dim
    exists (K1: keystream_cases)."""
    p = ctx.params
    n, r = p.n, p.r
    cases = []
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


def tail_prims(out: int, msg: int = 0) -> dict:
    """The encrypt tail's multiplies (csrc/fused_ops.cu EncryptTail) over
    `out` output residues, `msg` of them with the message: ra mod q_i
    (mod_nu) and the Shoup product by q_last^-1 each, and the Shoup product
    by q_i // t where there is a message."""
    return {"mod_nu": out, "shoup": out + msg}


def encrypt_work(ctx: BFVContext, u_b, pk, e2, m, J: int) -> Work:
    """K5 over J messages: r forward and 2r inverse transforms per message,
    two Montgomery products and two Shoup n^-1 per (h, modulus,
    coefficient), then the tail per output coefficient."""
    n, r = ctx.params.n, ctx.params.r
    tf, tc = ctx.tables_full, ctx.tail_consts
    out_coefs = J * 2 * (r - 1) * n
    tail = tail_prims(out_coefs, out_coefs // 2)
    return Work(nbytes(u_b, pk, e2, m, *tables(tf), tc.tail_rows)
                + 8 * out_coefs,
                shoup=3 * transform_butterflies(J * r, n) + 2 * J * r * n
                + tail["shoup"], mont=2 * J * r * n, mod_nu=tail["mod_nu"])


def decrypt_tail_work(x, c0, dt, coefs: int) -> Work:
    """Per coefficient and kept residue: a Shoup product mod q_i, one mod
    gamma and one 64-bit multiply by bcm_t; per coefficient a Montgomery
    product and a 64-bit multiply (pow2 t)."""
    rk = x.shape[-2]
    return Work(nbytes(x, c0, dt.k2_rows, dt.glob) + 8 * coefs,
                shoup=coefs * 2 * rk, mont=coefs, mullo=coefs * (rk + 1))


def behz_work(which: str, coefs: int, k: int, rl: int, nbytes_: int,
              live: int | None = None) -> Work:
    """A conversion's work over `coefs` coefficients and rl targets (live
    of them below the pad row, for 21c): k prescaling Shoup products; each
    target one linear form of k+1 128-bit products reduced once (a Shoup
    product and a mod_nu); 21a's u32 m_tilde channel; 21c's alpha a form of
    k+1 terms; scale_and_round both conversions over all k+1 and k
    targets."""
    live = rl if live is None else live
    forms = {"21a": rl, "21b": rl, "21c": 1 + live,
             "fused": (k + 1) + 1 + k}[which]
    return Work(nbytes_, shoup=coefs * (k + forms), mod_nu=coefs * forms,
                mul128=coefs * forms * (k + 1),
                mul32=coefs * (k + 1) if which == "21a" else 0)


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
        Work(nbytes(u_ntt, pk, e2, m, *tables(tf, "inv"), tc.tail_rows)
             + 8 * out_coefs,
             shoup=transform_butterflies(2 * r, n) + 2 * r * n
             + out_coefs + out_coefs // 2,
             mont=2 * r * n, mod_nu=out_coefs)))
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


# the server cells' (parameter set, J) for the stage engine's checks
ENGINE_CELLS = (("32k_9q", 8), ("32k_16q", 4), ("16k_5q", 16))


def engine_checks(dev, rng, errs: dict) -> dict:
    """The stage engine at each server cell's launch widths (ENGINE_CELLS):
    one request's six stage launches at the cell's J (the product's
    forward and inverse over q and over Bsk, the key switch's PRO_DIGIT
    forward and PRO_KSACC inverse) through the launchers' rule, each
    counted on the engine (tracing.stage_paths) and equal to its plain
    version; device us per launch (torch.profiler)."""
    res = {}
    for name, J in ENGINE_CELLS:
        p = get_bfv_params(name)
        ctx = BFVContext.build(p, device=dev)
        tf = ctx.tables_full
        n, r, k, ms = p.n, p.r, p.r - 1, tf.ms
        runs = []
        for label, t in (("q", ctx.tables_drop),
                         ("bsk", ctx._mult_setup().tables_bsk)):
            qs = [int(q) for q in t.ms.q.flatten()]
            x, y = (rand_res(rng, qs, n, (4 * J,), dev) for _ in range(2))
            of, oi = torch.empty_like(x), torch.empty_like(x)
            runs += [
                (f"fwd_{label}", of,
                 lambda x=x, t=t, o=of: ntt_stage.forward_launch(
                     dev, x, None, o, t, cuda.PRO_COPY),
                 lambda x=x, t=t: ntt.ntt_forward(x, t)),
                (f"inv_{label}", oi,
                 lambda x=x, y=y, t=t, o=oi: ntt_stage.inverse_launch(
                     dev, x, y, None, o, t),
                 lambda x=x, y=y, t=t: ntt.ntt_inverse(
                     ntt.dyadic_mul(x, y, t.ms), t))]
        c2 = torch.from_numpy(rng.integers(0, max(p.q), (J, k, n))).to(dev)
        ksk = rand_res(rng, p.q, n, (2, k), dev)
        dhat = torch.empty((J, k, r, n), dtype=torch.int64, device=dev)
        acc = torch.empty((J, 2, r, n), dtype=torch.int64, device=dev)
        runs += [
            ("fwd_ks", dhat,
             lambda: ntt_stage.forward_launch(dev, c2, None, dhat, tf,
                                              cuda.PRO_DIGIT, nu=ms.nu),
             lambda: ntt.ntt_forward(
                 modmath.mod_u64(c2[..., None, :], ms.q, ms.nu), tf)),
            ("inv_ks", acc,
             lambda: cuda.launch("ntt_stage_inverse_cluster", dev,
                                 dhat.data_ptr(), ksk.data_ptr(), None,
                                 acc.data_ptr(), *tf.kernel_args(),
                                 cuda.PRO_KSACC, k, J * 2 * r, r, p.logn,
                                 None, 0, 0, 0),
             lambda: fused_ops.keyswitch_front_plain(c2, ksk, tf))]
        for label, out, launch, plain in runs:
            tracing.reset()
            launch()
            paths = tracing.stage_paths()
            if paths != {"engine": 1, "one": 0}:
                raise AssertionError(f"stage engine {name} {label}: paths "
                                     f"{paths}")
            compare(f"stage engine {name} {label}", out, plain(), errs)
            res[f"{name} J={J} {label} P={out.numel() // n}"] = \
                device_us(launch)
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


def op_fits(B: int, n: int) -> bool:
    """Whether K3 and K4 take cluster size B at n points: one n/B u64
    buffer in at most 2^14 u64 (128 KB) a block."""
    return 2 <= n // B <= cuda.BLOCK_MAX_N


def op_cluster_calls(name: str, rng, dev, Js) -> tuple[BFVParams, list]:
    """K4 on seeded draws (nonce 1) and K3 over J seeded messages (each J
    of Js) against a seeded y, at the set's first r-1 moduli as decrypt
    runs it: (kernel, call at cluster size B, plain result) each."""
    p = get_bfv_params(name)
    tf = ntt.tables_for(p, device=dev)
    td = ntt.tables_for(p, p.r - 1, device=dev)
    s_b, a, e_d = sampling.keygen_draws_compact(p.n, p.r, tf.ms, nonce=1)
    y = rand_res(rng, p.q[:-1], p.n, (), dev)
    calls = [("keygen_fused",
              lambda B: fused_ops.keygen_fused(s_b, a, e_d, tf, cluster=B),
              fused_ops.keygen_fused_plain(s_b, a, e_d, tf))]
    for J in Js:
        x = rand_res(rng, p.q[:-1], p.n, (J,), dev)
        calls.append(("half_polymul",
                      lambda B, x=x: fused_ops.half_polymul(x, y, td,
                                                            cluster=B),
                      fused_ops.half_polymul_plain(x, y, td)))
    return p, calls


def op_cluster_checks(dev, rng, errs: dict) -> None:
    """K3 (J = 1 and 3) and K4 at cluster sizes B = 1, 2, 4, 8 at the
    OPC_CHECK_SETS against their plain versions; a B whose n/B buffer does
    not fit a block must be refused (the wrapper raises)."""
    for name in OPC_CHECK_SETS:
        p, calls = op_cluster_calls(name, rng, dev, (1, 3))
        took, refused = [], []
        for B in CLUSTER_BS:
            for kname, kern, ref in calls:
                if op_fits(B, p.n):
                    compare(kname, kern(B), ref, errs)
                    continue
                try:
                    kern(B)
                except RuntimeError:
                    continue
                raise AssertionError(f"{name} {kname} B={B}: launched where "
                                     f"an n/B buffer does not fit")
            (took if op_fits(B, p.n) else refused).append(B)
        log(f"check {name} K3 (J = 1, 3) and K4 at cluster sizes B={took}: "
            f"equal to their plain versions; B={refused}: refused (an n/B "
            f"buffer past 128 KB a block)")


def op_cluster_times(dev, rng, errs: dict) -> dict:
    """K3 (J = 1) and K4 at the OPC_TIME_SETS at every cluster size B a
    launch takes: device us per call (torch.profiler) and ms per call of
    20 back to back (CUDA events), the output held against its plain
    version."""
    res = {}
    for name in OPC_TIME_SETS:
        p, calls = op_cluster_calls(name, rng, dev, (1,))
        for kname, kern, ref in calls:
            label = "K4" if kname == "keygen_fused" else "K3"
            for B in CLUSTER_BS:
                key = f"{label} {name} B={B}"
                if not op_fits(B, p.n):
                    res[key] = "refused"
                    continue
                compare(kname, kern(B), ref, errs)
                res[key] = {"rule": B == ntt_stage.cluster_size(p.n),
                            "us": device_us(lambda: kern(B)),
                            "ms": kernel_ms(lambda: kern(B))}
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
             behz_work("21a", coefs_a, k, k + 1,
                       nbytes(xa, *banks) + 8 * coefs_a * (k + 1))),
            ("behz_fast_floor", J,
             lambda a=xq, b=xb: behz_kernels.fast_floor(a, b, mb),
             lambda a=xq, b=xb: behz_kernels.fast_floor_plain(a, b, mb),
             behz_work("21b", coefs_f, k, k + 1,
                       nbytes(xq, xb, *banks) + nbytes(xb))),
            ("behz_bsk_to_q", J,
             lambda b=xb: behz_kernels.bsk_to_q(b, mb),
             lambda b=xb: behz_kernels.bsk_to_q_plain(b, mb),
             behz_work("21c", coefs_f, k, k, nbytes(xb, *banks) + nbytes(xq))),
            ("behz_scale_and_round", J,
             lambda a=xq, b=xb: behz_kernels.scale_and_round(a, b, mb),
             lambda a=xq, b=xb: behz_kernels.scale_and_round_plain(a, b, mb),
             behz_work("fused", coefs_f, k, k,
                       nbytes(xq, xb, *banks) + nbytes(xq))),
        ]
        c2 = rand_res(rng, p.q[:-1], n, lead, dev)
        ksk = rand_res(rng, p.q, n, (2, k), dev)
        out_coefs = J * 2 * k * n
        cases.append((
            "keyswitch_fused", J,
            lambda c=c2, s=ksk: fused_ops.keyswitch_fused(c, s, tf, tc),
            lambda c=c2, s=ksk: fused_ops.keyswitch_fused_plain(c, s, tf, tc),
            Work(nbytes(c2, ksk, *tables(tf), tc.tail_rows) + 8 * out_coefs,
                 shoup=transform_butterflies(J * (k + 2) * r, n)
                 + J * 2 * r * n + out_coefs,
                 mod_nu=J * k * r * n + out_coefs,
                 mont=J * 2 * r * n * k)))
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


# The conversion kernels (csrc/behz.cu) and K2 (csrc/decrypt_tail.cu) at
# the group size G (threads a coefficient) the launchers' rule takes: the
# sets they are held and timed at (G = 2 below 2^16 coefficients a launch,
# 1 from there; K2 2 up to 8 residue rows, then 4), and the bands of the
# sharded EvalMult at each (R = 1's rows and the last rank of R = 3's,
# with m_sk's row and bsk_to_q's pad row).
GROUP_SETS = ("4k_3q", "16k_5q", "32k_9q", "32k_16q")


def group_bands(r: int) -> tuple:
    return ((0, r), (r - max(r // 3, 1), max(r // 3, 1)))


def group_cases(p: BFVParams, dev, rng, J: int) -> list:
    """(kernel, label, call, plain call, Work) for 21a-c, scale_and_round
    and the bands at p at the EvalMult path's shapes with a J lead (21a
    over (J, 2, 2, k, n), the rest over (J, 3, ., n)), and K2 at (J + 1 if
    J > 1, r-1, n) (J = 1 and 3)."""
    n, k = p.n, p.r - 1
    aux = behz.AuxBase.build(p)
    mc = behz_kernels.SpmdMultConsts.build(p, aux, dev)
    mb = mc.banks
    banks = [mb.qsrc, mb.tgt, mb.amat, mb.bsrc, mb.bmat, mb.bfin, mb.glob]
    lead = () if J == 1 else (J,)
    xa = rand_res(rng, p.q[:k], n, lead + (2, 2), dev)
    xq = rand_res(rng, p.q[:k], n, lead + (3,), dev)
    xb = rand_res(rng, aux.bsk, n, lead + (3,), dev)
    ca, cf = xa.numel() // (k * n), xq.numel() // (k * n)
    sa, sf = ca * n, cf * n
    bk = behz_kernels
    label = f"{p.name} J={J}"
    cases = [
        ("behz_rns_to_bsk", label,
         lambda: bk.rns_to_bsk(xa, mb), lambda: bk.rns_to_bsk_plain(xa, mb),
         behz_work("21a", sa, k, k + 1, nbytes(xa, *banks) + 8 * sa * (k + 1))),
        ("behz_fast_floor", label,
         lambda: bk.fast_floor(xq, xb, mb),
         lambda: bk.fast_floor_plain(xq, xb, mb),
         behz_work("21b", sf, k, k + 1, nbytes(xq, xb, *banks) + nbytes(xb))),
        ("behz_bsk_to_q", label,
         lambda: bk.bsk_to_q(xb, mb), lambda: bk.bsk_to_q_plain(xb, mb),
         behz_work("21c", sf, k, k, nbytes(xb, *banks) + nbytes(xq))),
        ("behz_scale_and_round", label,
         lambda: bk.scale_and_round(xq, xb, mb),
         lambda: bk.scale_and_round_plain(xq, xb, mb),
         behz_work("fused", sf, k, k, nbytes(xq, xb, *banks) + nbytes(xq))),
    ]
    for lo, rl in group_bands(p.r):
        live = min(lo + rl, k) - lo
        xbr = xb[..., lo:lo + rl, :].contiguous()
        bl = f"{label} rows {lo}-{lo + rl}"
        cases += [
            ("behz_rns_to_bsk_rows", bl,
             lambda lo=lo, rl=rl: bk.rns_to_bsk_rows(xa, mc, lo, rl),
             lambda lo=lo, rl=rl: bk.rns_to_bsk_rows_plain(xa, mc, lo, rl),
             behz_work("21a", sa, k, rl, nbytes(xa, *banks) + 8 * sa * rl)),
            ("behz_fast_floor_rows", bl,
             lambda lo=lo, rl=rl, b=xbr: bk.fast_floor_rows(xq, b, mc, lo,
                                                            rl),
             lambda lo=lo, rl=rl, b=xbr: bk.fast_floor_rows_plain(
                 xq, b, mc, lo, rl),
             behz_work("21b", sf, k, rl, nbytes(xq, xbr, *banks)
                       + nbytes(xbr))),
            ("behz_bsk_to_q_rows", bl,
             lambda lo=lo, rl=rl: bk.bsk_to_q_rows(xb, mc, lo, rl),
             lambda lo=lo, rl=rl: bk.bsk_to_q_rows_plain(xb, mc, lo, rl),
             behz_work("21c", sf, k, rl, nbytes(xb, *banks) + 8 * sf * rl,
                       live)),
        ]
    Jd = 1 if J == 1 else J + 1
    dt = bfv_tail.DecTailConsts.build(p, dev)
    dl = () if Jd == 1 else (Jd,)
    x = rand_res(rng, p.q[:k], n, dl, dev)
    c0 = rand_res(rng, p.q[:k], n, dl, dev)
    cases.append(("decrypt_tail", f"{p.name} J={Jd}",
                  lambda: bfv_tail.decrypt_tail(x, c0, dt),
                  lambda: bfv_tail.decrypt_tail_plain(x, c0, dt),
                  decrypt_tail_work(x, c0, dt, Jd * n)))
    return cases


def group_checks(dev, rng, errs: dict) -> None:
    """21a-c, scale_and_round, the bands and K2 exactly against their
    plain versions at GROUP_SETS, J = 1 and 2 (K2 at J = 1 and 3)."""
    for name in GROUP_SETS:
        p = get_bfv_params(name)
        for J in (1, 2):
            for kname, label, call, plain, _ in group_cases(p, dev, rng, J):
                compare(kname, call(), plain(), errs)
                log(f"check {kname} {label}: equal")


def group_times(dev, rng, mults: dict, clock_hz: float) -> dict:
    """Device us per call (torch.profiler, 10 calls a window, two windows)
    of each conversion, band and K2 at GROUP_SETS, J = 1 (K2 also J = 3),
    beside its bound at the same shape; scale_and_round also beside 21b
    then 21c, the two launches it replaces."""
    res = {}
    for name in GROUP_SETS:
        p = get_bfv_params(name)
        cases = group_cases(p, dev, rng, 1) + [
            c for c in group_cases(p, dev, rng, 2) if c[0] == "decrypt_tail"]
        by = {(c[0], c[1]): c for c in cases}
        mb = behz_kernels.SpmdMultConsts.build(p, behz.AuxBase.build(p),
                                               dev).banks
        for kname, label, call, _, work in cases:
            bound_ms, bound_by = work.bound(mults, clock_hz)
            row = {"bound_us": bound_ms * 1e3, "bound_by": bound_by,
                   "us": [device_us(call, 10), device_us(call, 10)]}
            if kname == "behz_scale_and_round":
                floor = by[("behz_fast_floor", label)][2]
                row["21b+21c us"] = [device_us(
                    lambda: behz_kernels.bsk_to_q(floor(), mb), 10)
                    for _ in range(2)]
            res[f"{kname} {label}"] = row
    return res


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def tail_cases(p: BFVParams, dev, rng, Js=(1, BATCH_J)) -> list:
    """(label, C entry, raw args, out, plain result, the tensors behind the
    args, Work) of every launch form of the encrypt tail (csrc/fused_ops.cu
    EncryptTail) at p's main-path shapes: K5's and 13's at each J of Js,
    19's drop, 14's, 16's and its drop's at rows 0-r and 6-r."""
    n, r, rk = p.n, p.r, p.r - 1
    tc = bfv_tail.TailConsts.build(p, dev)
    glob = (tc.q_last, tc.half, tc.fix_th)
    cases = []
    for J, msg in [(J, True) for J in Js] + [(1, False)]:
        sc = rand_res(rng, p.q, n, (J, 2), dev)
        m = torch.from_numpy(rng.integers(0, p.t, (J, n))).to(dev)
        ct = torch.empty((J, 2, rk, n), dtype=torch.int64, device=dev)
        want = poly.divide_and_round_q_last(sc, tc.dr, tc.ms_drop, tc.ms_last)
        if msg:
            want[:, 0] = poly.add_message(want[:, 0], m, tc.msg)
        out = J * 2 * rk * n
        cases.append((
            f"K5 J={J}" if msg else "19 drop J=1", "ntt_encrypt_tail",
            (ptr(sc), ptr(m) if msg else None, ptr(ct), ptr(tc.tail_rows),
             *glob, J, r, n), ct, want, (sc, m, tc),
            Work(nbytes(sc, tc.tail_rows, ct) + (nbytes(m) if msg else 0),
                 **tail_prims(out, out // 2 if msg else 0))))
    c, e = (rand_res(rng, p.q, n, (2,), dev) for _ in range(2))
    m = torch.from_numpy(rng.integers(0, p.t, n)).to(dev)
    ct = torch.empty((2, rk, n), dtype=torch.int64, device=dev)
    cases.append((
        "14", "ntt_encrypt_tail_e",
        (ptr(c), ptr(e), ptr(m), ptr(ct), ptr(tc.tail_rows), *glob, r, n),
        ct, bfv_tail.encrypt_tail_plain(c, e, m, tc), (c, e, m, tc),
        Work(nbytes(c, e, m, tc.tail_rows, ct),
             **tail_prims(ct.numel(), ct.numel() // 2))))
    mc = behz_kernels.SpmdMultConsts.build(p, behz.AuxBase.build(p), dev)
    for lo, hi in ((0, r), (6, r)):
        rl = hi - lo
        pt = bfv_tail.build_tail_consts_padded(p, lo, hi, dev)
        c, e = (rand_res(rng, p.q[lo:hi], n, (2,), dev) for _ in range(2))
        ra = torch.from_numpy(rng.integers(0, p.q[-1], (2, n))).to(dev)
        ct = torch.empty((2, rl, n), dtype=torch.int64, device=dev)
        cases.append((
            f"16 rows {lo}-{hi}", "ntt_encrypt_tail_padded",
            (ptr(c), ptr(e), ptr(ra), ptr(m), ptr(ct), ptr(pt.tail_rows),
             pt.q_last, pt.fix_th, rl, n), ct,
            bfv_tail.encrypt_tail_padded_plain(c, e, ra, m, pt),
            (c, e, ra, m, pt),
            Work(nbytes(c, e, ra, m, pt.tail_rows, ct),
                 **tail_prims(ct.numel(), ct.numel() // 2))))
        dc = spmd_mult.drop_consts(mc, p.q[-1], lo, hi)
        ct2 = torch.empty_like(ct)
        cases.append((
            f"16 drop rows {lo}-{hi}", "ntt_drop_last_padded",
            (ptr(c), ptr(ra), ptr(ct2), ptr(dc.tail_rows), dc.q_last, rl, n),
            ct2, bfv_tail.drop_last_padded_plain(c, ra, dc), (c, ra, dc),
            Work(nbytes(c, ra, dc.tail_rows, ct2), **tail_prims(ct2.numel()))))
    return cases


def partial_cases(p: BFVParams, dev, rng) -> list:
    """tail_cases' tuples for kernel 17 at p's rank rows 0-r and 6-r,
    levels 0 and 1."""
    n, r = p.n, p.r
    cases = []
    for lo, hi in ((0, r), (6, r)):
        x, c0 = (rand_res(rng, p.q[lo:hi], n, (), dev) for _ in range(2))
        for level in (0, 1):
            cp = spmd._chain_params(p, level)
            dc = bfv_tail.build_dec_tail_consts_padded(
                cp, lo, min(hi, cp.r), pad_to=hi, device=dev)
            out = torch.empty((2, n), dtype=torch.int64, device=dev)
            t, rl = dc.t, hi - lo
            cases.append((
                f"17 rows {lo}-{hi} level {level}", "ntt_decrypt_tail_partial",
                (ptr(x), ptr(c0), ptr(out), ptr(dc.k2_rows), ptr(dc.glob), rl,
                 n, int(t & (t - 1) == 0), t, dc.nu_t), out,
                torch.stack(bfv_tail.decrypt_tail_partial_plain(x, c0, dc)),
                (x, c0, dc),
                Work(nbytes(x, c0, dc.k2_rows, dc.glob, out),
                     shoup=2 * rl * n, mullo=rl * n)))
    return cases


# the kernels line's row of each tail case's label prefix
TAIL_ROWS = {"K5": "encrypt_fused", "19": "keyswitch_fused",
             "14": "encrypt_tail", "16": "encrypt_tail_padded",
             "17": "decrypt_tail_partial"}


def tail_times(dev, rng, mults: dict, clock_hz: float, errs: dict) -> dict:
    """Every encrypt tail form and kernel 17 at STAGE_SET (tail_cases,
    partial_cases) through the library's C entry, each output (cleared
    first) held against its plain version, then device us per call
    (torch.profiler, two windows of 10 calls) beside its bound."""
    lib, res = cuda.library(), {}
    p = get_bfv_params(STAGE_SET)
    cases = tail_cases(p, dev, rng) + partial_cases(p, dev, rng)
    for label, entry, args, out, want, _, work in cases:
        def call(entry=entry, args=args, out=out):
            raw_launch(lib, entry, *args)
            return out
        out.fill_(-1)
        compare(TAIL_ROWS[label.split()[0]], call(), want, errs)
        bound_ms, bound_by = work.bound(mults, clock_hz)
        res[label] = {"us": [device_us(call, 10) for _ in range(2)],
                      "bound_us": bound_ms * 1e3, "bound_by": bound_by}
    return res


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


def ntt30_fits(B: int, n: int) -> bool:
    """Whether kernel 22 takes cluster size B at n points: n/B u32 in
    128 KB of a block."""
    return 2 <= n // B <= 2 * cuda.BLOCK_MAX_N


def ntt30_checks(dev, rng, errs: dict) -> dict:
    """Kernel 22 against its plain version and the 64-bit plain transform
    at every size and shape, by the rule and at every cluster size B (a B
    that does not fit raises); returns the (16, 1, n) int32 timing cases at
    2^15 and 2^16 by (n, direction) as (wrapper call of B, plain call,
    Work)."""
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
                for B in CLUSTER_BS:
                    if not ntt30_fits(B, n):
                        for fn in (ntt30.ntt_forward, ntt30.ntt_inverse):
                            try:
                                fn(xd, tb, cluster=B)
                            except RuntimeError:
                                continue
                            raise AssertionError(f"kernel 22 took B={B} at "
                                                 f"n={n}")
                        continue
                    compare("ntt30_transform",
                            ntt30.ntt_forward(xd, tb, cluster=B), f, errs)
                    compare("ntt30_transform",
                            ntt30.ntt_inverse(f, tb, cluster=B), i, errs)
            log(f"check ntt30_transform n={n} {lead + (n,)} int32/int64 "
                f"fwd/inv: equal to the plain versions and the 64-bit "
                f"transform, by the rule and at B = "
                f"{[B for B in CLUSTER_BS if ntt30_fits(B, n)]} (the rest "
                f"refused)")
            if lead[0] == NTT30_BATCH and n >= 32768:
                x32 = x.to(torch.int32)
                f32 = ntt30.ntt_forward(x32, tb)
                timing[(n, "fwd")] = (
                    lambda B=0, x32=x32, tb=tb: ntt30.ntt_forward(
                        x32, tb, cluster=B),
                    lambda x32=x32, tb=tb: ntt30.ntt_forward_plain(x32, tb),
                    ntt30_work(x32, tb, False))
                timing[(n, "inv")] = (
                    lambda B=0, f32=f32, tb=tb: ntt30.ntt_inverse(
                        f32, tb, cluster=B),
                    lambda f32=f32, tb=tb: ntt30.ntt_inverse_plain(f32, tb),
                    ntt30_work(f32, tb, True))
    return timing


def ntt30_cluster_times(timing30: dict) -> dict:
    """Kernel 22 at (16, 1, n), n = 2^15 and 2^16, both directions, at
    every cluster size B a launch takes: device us per call
    (torch.profiler) and ms per call of 20 back to back (CUDA events)."""
    res = {}
    for (n, direction), (kern, _, _) in timing30.items():
        for B in CLUSTER_BS:
            key = f"n={n} {direction} B={B}"
            if not ntt30_fits(B, n):
                res[key] = "refused"
                continue
            res[key] = {"rule": B == 8,   # 8 wherever it fits
                        "us": device_us(lambda: kern(B)),
                        "ms": kernel_ms(lambda: kern(B))}
    return res


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
                Work(nbytes(c, e, ra, m, tc.tail_rows) + 8 * out,
                     **tail_prims(out, out // 2))))
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
                    Work(nbytes(x, c0, dc.k2_rows, dc.glob) + 16 * n,
                         shoup=2 * rl * n, mullo=rl * n)))
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
             behz_work("21a", coefs_a, k, rl,
                       nbytes(xa, *banks) + 8 * coefs_a * rl)),
            ("behz_fast_floor_rows", label,
             lambda a=xq, b=xb, lo=lo, rl=rl: behz_kernels.fast_floor_rows(
                 a, b, mc, lo, rl),
             lambda a=xq, b=xb, lo=lo, rl=rl:
                 behz_kernels.fast_floor_rows_plain(a, b, mc, lo, rl),
             behz_work("21b", coefs_f, k, rl,
                       nbytes(xq, xb, *banks) + nbytes(xb))),
            ("behz_bsk_to_q_rows", label,
             lambda x=fl, lo=lo, rl=rl: behz_kernels.bsk_to_q_rows(
                 x, mc, lo, rl),
             lambda x=fl, lo=lo, rl=rl: behz_kernels.bsk_to_q_rows_plain(
                 x, mc, lo, rl),
             behz_work("21c", coefs_f, k, rl,
                       nbytes(fl, *banks) + 8 * coefs_f * rl, live)),
            ("encrypt_tail_padded", f"{label} drop",
             lambda c=cc, ra=ra, tc=tc: bfv_tail.drop_last_padded(c, ra, tc),
             lambda c=cc, ra=ra, tc=tc: bfv_tail.drop_last_padded_plain(
                 c, ra, tc),
             Work(nbytes(cc, ra, tc.tail_rows) + 8 * out,
                  **tail_prims(out))),
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
            Work(nbytes(c, e, m, tc.tail_rows) + 8 * out,
                 **tail_prims(out, out // 2))))
    for name in DEC_FUSED_SETS:
        p = get_bfv_params(name)
        td = ntt.tables_for(p, p.r - 1, device=dev)
        dt = bfv_tail.DecTailConsts.build(p, dev)
        x, sk, c0 = (rand_res(rng, p.q[:-1], p.n, (), dev) for _ in range(3))
        cases.append((
            "decrypt_fused", name,
            lambda B=0, x=x, sk=sk, c0=c0, td=td, dt=dt:
                bfv_tail.decrypt_fused(x, sk, c0, td, dt, cluster=B),
            lambda x=x, sk=sk, c0=c0, td=td, dt=dt:
                bfv_tail.decrypt_fused_plain(x, sk, c0, td, dt),
            decrypt_fused_work(x, sk, c0, td, dt)))
    return cases


def dec_fits(B: int, n: int) -> bool:
    """Whether kernel 15 takes cluster size B at n points (n/B u64 in a
    block)."""
    return 2 <= n // B <= cuda.BLOCK_MAX_N


def decrypt_cluster_checks(cases, errs: dict) -> None:
    """Kernel 15 (the ops_cases rows) at every cluster size B against its
    plain version; a B that does not fit raises."""
    for kname, label, kern, plain, _ in cases:
        if kname != "decrypt_fused":
            continue
        ref = plain()
        n = ref.shape[-1]
        for B in CLUSTER_BS:
            if dec_fits(B, n):
                compare(kname, kern(B), ref, errs)
                continue
            try:
                kern(B)
            except RuntimeError:
                continue
            raise AssertionError(f"kernel 15 took B={B} at n={n}")
        log(f"check decrypt_fused {label} at B = "
            f"{[B for B in CLUSTER_BS if dec_fits(B, n)]}: equal (the rest "
            f"refused)")


def decrypt_cluster_times(cases) -> dict:
    """Kernel 15 at every cluster size B a launch takes: device us per call
    (torch.profiler) and ms per call of 20 back to back (CUDA events)."""
    res = {}
    for kname, label, kern, plain, _ in cases:
        if kname != "decrypt_fused":
            continue
        n = get_bfv_params(label).n
        for B in CLUSTER_BS:
            key = f"{label} B={B}"
            if not dec_fits(B, n):
                res[key] = "refused"
                continue
            res[key] = {"rule": B == ntt_stage.cluster_size(n),
                        "us": device_us(lambda: kern(B)),
                        "ms": kernel_ms(lambda: kern(B))}
    return res


def decrypt_fused_work(x, sk, c0, td, dt) -> Work:
    """Kernel 15: kernel 8's inverse (the Montgomery product, the
    butterflies, the n^-1 Shoup) and K2's residue loop (two Shoup products
    a row), x, sk and c0 read once and the (n,) plaintext written once."""
    rk, n = x.shape
    return Work(nbytes(x, sk, c0, *tables(td, "inv"), dt.k2_rows, dt.glob)
                + 8 * n, shoup=transform_butterflies(rk, n) + 3 * rk * n,
                mont=rk * n + n, mullo=n * (rk + 1))


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
    mesh at SPMD_SET: drive_spmd2d, then the 2-D EvalMult on its keys and
    ciphertexts (drive_spmd2d_mult), counts read around each; the rank's
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
        counts = read_counts()
        mctx2 = spmd2d_mult.Spmd2DMultContext.build(ctx2)
        reset_counts()
        resm = drive_spmd2d_mult(mctx2, res)
        local = {**res["local"], **resm["local"]}
        np.savez(out / f"rank{rank}.npz",
                 **{k: v.cpu().numpy() for k, v in local.items()})
        (out / f"rank{rank}.json").write_text(json.dumps(
            {"collectives": {**res["collectives"], **resm["collectives"]},
             "counts": counts, "counts_mult": read_counts(),
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
            "counts": [m["counts"] for m in meta],
            "counts_mult": [m["counts_mult"] for m in meta]}


def spmd2d_mult_cases(p: BFVParams, dev, rng):
    """(kernel, label, wrapper call, plain call, Work) for kernel 20's
    launch on a coefficient shard (coef_kernels.local_keyswitch_acc) at
    p's 2-D rank shapes KSACC_CASES, every shard: d^ (k, rl, S) and the
    key block (2, k, rl, S) -> (2, rl, S)."""
    n, k = p.n, p.r - 1
    cases = []
    for C, (lo, hi) in KSACC_CASES:
        rl, S, logc = hi - lo, n // C, C.bit_length() - 1
        tb = ntt.NTTTables.build(p.q[lo:hi], p.psi[lo:hi], n, dev)
        for c in range(C):
            dhat = rand_res(rng, p.q[lo:hi], S, (k,), dev)
            ksk = rand_res(rng, p.q[lo:hi], S, (2, k), dev)
            out = 2 * rl * S
            inv = tables(tb, "inv")
            cases.append((
                "keyswitch_acc_shard",
                f"{p.name} rows {lo}-{hi} C={C} shard {c}",
                lambda d=dhat, s=ksk, tb=tb, logc=logc, c=c:
                    coef_kernels.local_keyswitch_acc(d, s, tb, logc, c),
                lambda d=dhat, s=ksk, tb=tb, C=C, c=c:
                    coef_kernels.local_keyswitch_acc_plain(d, s, tb, C, c),
                # the shard reads 1/C of the inverse twiddles
                Work(nbytes(dhat, ksk, inv[-1]) + nbytes(*inv[:-1]) // C
                     + 8 * out,
                     shoup=transform_butterflies(2 * rl, S) + out,
                     mont=k * out)))
    return cases


def drive_spmd2d_mult(mctx2: spmd2d_mult.Spmd2DMultContext,
                      res: dict) -> dict:
    """On drive_spmd2d's keys and first two ciphertexts: relin_keygen, mul,
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

    base, ds = mctx2.base, res["dtensor"]
    sk, c0, c1 = ds["sk"], ds["ct0"], ds["ct1"]
    rlk = counted("relin_keygen", lambda: mctx2.relin_keygen(sk, nonce=1))
    mul3 = counted("mul", lambda: mctx2.mul(c0, c1))
    rel = counted("relinearize", lambda: mctx2.relinearize(mul3, rlk))
    mul_rlk = counted("mul_rlk", lambda: mctx2.mul(c0, c1, rlk=rlk))
    gk = counted("galois_keygen", lambda: mctx2.galois_keygen(
        sk, [SPMD_GALOIS], nonce=1))[SPMD_GALOIS]
    gal = counted("apply_galois", lambda: mctx2.apply_galois(
        c0, SPMD_GALOIS, gk))
    out = dict(rlk=rlk, mul3=mul3, rel=rel, gk=gk, gal=gal, mul_rlk=mul_rlk,
               dec3=counted("decrypt3", lambda: mctx2.decrypt3(sk, mul3)),
               dec_rel=base.decrypt(sk, rel), dec_gal=base.decrypt(sk, gal))
    torch.cuda.synchronize()
    return {"local": {k: v.to_local() for k, v in out.items()},
            "dtensor": out, "collectives": ops}


def check_spmd2d_mult(p: BFVParams, whole: dict, collectives: dict, R: int,
                      C: int, msgs: np.ndarray, ref: dict) -> None:
    """The product's decrypts equal the negacyclic m1 m2 mod t and the
    rotation's tau_g(m1); keys whole and live rows equal the single card's
    `ref` (spmd_mult_reference), mul's pad row 0; the collectives the JAX
    package's budget: a mul four all-gathers over 'rns' (with rlk the key
    switch's one more and one all-reduce), apply_galois one more over
    'coef', every transform log2 C ppermutes."""
    r, n, k = p.r, p.n, p.r - 1
    rl, S, logc = r // R, n // C, sharded.log2_shards(C)
    dev = whole["dec3"].device
    prod = negacyclic_mod_t(msgs[0], msgs[1], p, dev)
    want = {"dec3": prod, "dec_rel": prod,
            "dec_gal": tau_mod_t(msgs[0], SPMD_GALOIS, p, dev)}
    for key, w in want.items():
        if not torch.equal(whole[key].to(dev), w):
            raise AssertionError(f"2-D EvalMult {R}x{C}: {key} does not "
                                 f"decrypt to its mod-t result")
    same = all(torch.equal(whole[key], ref[key]) for key in ("rlk", "gk"))
    same = same and all(torch.equal(whole[key][:, :k], ref[w]) for key, w in
                        (("mul3", "mul3"), ("rel", "rel"),
                         ("mul_rlk", "rel"), ("gal", "gal")))
    if not same or whole["mul3"][:, k].any():
        raise AssertionError(f"2-D EvalMult {R}x{C}: keys / live rows != "
                             f"the single-card BFVContext, or mul's pad row "
                             f"not 0")

    def pp(*shape):
        return [("ppermute", shape)] * logc

    tensor = pp(4, rl, S) + pp(3, rl, S)
    mul = ([("all_gather", (2, r, S))] * 2 + tensor + tensor
           + [("all_gather", (3, r, S))] * 2)
    switch = ([("all_gather", (r, S))] + pp(k, rl, S) + pp(2, rl, S)
              + [("all_reduce", (2, S))])
    budget = {"relin_keygen": [pp(k, rl, S) * 2], "mul": [mul],
              "relinearize": [switch], "mul_rlk": [mul + switch],
              "galois_keygen": [pp(rl, S) + [("all_gather", (rl, n))]
                                + pp(1, rl, S) + pp(k, rl, S) * 2],
              "apply_galois": [[("all_gather", (2, rl, n))] + switch],
              "decrypt3": [pp(2, rl, S) + pp(rl, S)
                           + [("all_reduce", (3, S))]]}
    got = {key: [[(op, tuple(sh)) for op, sh in call] for call in v]
           for key, v in collectives.items()}
    if got != budget:
        raise AssertionError(f"2-D EvalMult {R}x{C}: collectives {got}, "
                             f"expected {budget}")


def drive_rns(ctx, msgs: np.ndarray) -> dict:
    """The 16 methods of the JAX package's ShardedBFVContext on `ctx` (a
    ShardedBFVContext, or a BFVContext for the same calls on one card):
    keygen, encrypt of the first two messages, add, sub, relin_keygen,
    galois_keygen([SPMD_GALOIS]), mul with and without rlk, square with
    rlk, apply_galois, add_plain, mul_plain, decrypt of a fresh, an L = 3
    and a relinearized ciphertext, encrypt_batch (nonces 1, 2) and
    decrypt_batch, mod_switch_to_next and the next_context() decrypt.
    Returns every output whole (DTensors gathered)."""
    from torch.distributed.tensor import DTensor
    m1, m2 = (torch.from_numpy(m) for m in msgs[:2])
    sk, pk = ctx.keygen()
    c1, c2 = ctx.encrypt(pk, m1), ctx.encrypt(pk, m2)
    rlk = ctx.relin_keygen(sk, nonce=1)
    gk = ctx.galois_keygen(sk, [SPMD_GALOIS], nonce=1)[SPMD_GALOIS]
    out = dict(sk=sk, pk=pk, c1=c1, c2=c2, rlk=rlk, gk=gk,
               add=ctx.add(c1, c2), sub=ctx.sub(c1, c2), ct3=ctx.mul(c1, c2),
               mul_rlk=ctx.mul(c1, c2, rlk=rlk),
               square=ctx.square(c1, rlk=rlk),
               gal=ctx.apply_galois(c1, SPMD_GALOIS, gk),
               add_plain=ctx.add_plain(c1, m2), mul_plain=ctx.mul_plain(c1, m2))
    out.update(dec=ctx.decrypt(sk, c1), dec3=ctx.decrypt(sk, out["ct3"]),
               dec_rlk=ctx.decrypt(sk, out["mul_rlk"]),
               batch=ctx.encrypt_batch(pk, torch.stack([m1, m2]), [1, 2]))
    out["dec_batch"] = ctx.decrypt_batch(sk, out["batch"])
    out["sw"] = ctx.mod_switch_to_next(c1)
    r = (ctx.inner if isinstance(ctx, rns.ShardedBFVContext) else ctx).params.r
    out["dec_sw"] = ctx.next_context().decrypt(sk[:r - 1], out["sw"])
    torch.cuda.synchronize()
    return {k: pmesh.gather_whole(v) if isinstance(v, DTensor) else v
            for k, v in out.items()}


def check_rns(p: BFVParams, got: dict, ref: dict, msgs: np.ndarray,
              label: str) -> None:
    """Every output of drive_rns equal to the single card's `ref`, and the
    decrypts to their messages and the negacyclic m1 m2 mod t."""
    diff = [k for k, v in ref.items()
            if not torch.equal(got[k].to(v.device), v)]
    if diff or sorted(got) != sorted(ref):
        raise AssertionError(f"ShardedBFVContext {label}: {diff} != the "
                             f"single-card BFVContext")
    dev = ref["dec"].device
    m1, m2 = (torch.from_numpy(m).to(dev) for m in msgs[:2])
    prod = negacyclic_mod_t(msgs[0], msgs[1], p, dev)
    want = {"dec": m1, "dec3": prod, "dec_rlk": prod,
            "dec_batch": torch.stack([m1, m2]), "dec_sw": m1}
    for k, w in want.items():
        if not torch.equal(got[k].to(dev), w):
            raise AssertionError(f"ShardedBFVContext {label}: {k} does not "
                                 f"decrypt to its message")


def rns_worker(rank: int, R: int, address: str, out: Path) -> None:
    """One rank of a one-card gloo run of ShardedBFVContext (chip_smoke.py
    re-run as `--rns-worker rank R address out`) on the default (R, 1)
    mesh at SPMD_SET: drive_rns, counts read around it; rank 0's outputs
    to rns.npz, every rank's counts and branch to rank<rank>.json."""
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    multihost.initialize(address, R, rank, backend="gloo")
    try:
        ctx = rns.ShardedBFVContext.build(get_bfv_params(SPMD_SET))
        reset_counts()
        got = drive_rns(ctx, spmd_messages(ctx.inner.params))
        (out / f"rank{rank}.json").write_text(json.dumps(
            {"counts": read_counts(), "sharded": ctx.spmd is not None}))
        if rank == 0:
            np.savez(out / "rns.npz",
                     **{k: v.cpu().numpy() for k, v in got.items()})
    finally:
        torch.distributed.destroy_process_group()


def start_rns_ranks(R: int, out: Path) -> list:
    address = free_address()
    return start_workers(["--rns-worker"], [[str(rank), str(R), address,
                                             str(out)] for rank in range(R)])


def finish_rns_ranks(R: int, procs: list, out: Path) -> dict:
    """Wait for start_rns_ranks' workers: rank 0's outputs, every rank's
    counts and branch."""
    wait_workers(procs, f"ShardedBFVContext R={R}")
    meta = [json.loads((out / f"rank{k}.json").read_text())
            for k in range(R)]
    return {"got": {k: torch.from_numpy(v) for k, v in
                    np.load(out / "rns.npz").items()},
            "counts": [m["counts"] for m in meta],
            "sharded": [m["sharded"] for m in meta]}


def reset_counts() -> None:
    tracing.reset()


def read_counts() -> dict[str, int]:
    c = tracing.counts()
    return {k: sum(c[w] for w in ws) for k, (ws, *_) in KERNELS.items()}


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


def program_cases(ctx: BFVContext, msgs: np.ndarray) -> list:
    """The op programs of ctx (op_programs, mult_program) on the phase's
    inputs, as (name, fn, args, eager, nonce): keys at nonce 1, the first
    two messages encrypted at 1 and 2, PROGRAM_DEC_J of them batched;
    eager(v) is the public method with the program's nonce at v, and
    nonce(v) the static nonce input's value at v (None: no nonce)."""
    p, dev = ctx.params, ctx.device
    kg_fn, enc_fn, dec_fn, encb_fn, decb_fn, bz = ctx.op_programs()
    mul_fn, sq_fn, mbz = ctx.mult_program()
    m = torch.from_numpy(msgs).to(dev)
    sk, pk = ctx.keygen(nonce=1)
    rlk = ctx.relin_keygen(sk, nonce=1)
    ct, ct2 = (ctx.encrypt(pk, m[j], nonce=j + 1) for j in range(2))
    J, Jd = m.shape[0], PROGRAM_DEC_J
    cts = ctx.encrypt_batch(pk, m[:Jd], list(range(1, Jd + 1)))
    sk_drop = sk[:p.r - 1]

    def one(v):
        return torch.tensor(v, dtype=torch.int64, device=dev)

    def batch(v):
        return torch.arange(v, v + J, dtype=torch.int64, device=dev)
    v0 = PROGRAM_NONCES[0]
    return [
        ("keygen", kg_fn, (one(v0), bz), lambda v: ctx.keygen(nonce=v), one),
        ("encrypt", enc_fn, (one(v0), pk, m[0], bz),
         lambda v: ctx.encrypt(pk, m[0], nonce=v), one),
        ("decrypt", dec_fn, (sk, ct, bz), lambda v: ctx.decrypt(sk, ct), None),
        ("decrypt_sk_drop", dec_fn, (sk_drop, ct, bz),
         lambda v: ctx.decrypt(sk_drop, ct), None),
        (f"encrypt_batch_J{J}", encb_fn, (batch(v0), pk, m, bz),
         lambda v: ctx.encrypt_batch(pk, m, list(range(v, v + J))), batch),
        (f"decrypt_batch_J{Jd}", decb_fn, (sk, cts, bz),
         lambda v: ctx.decrypt_batch(sk, cts), None),
        ("mul_relin", mul_fn, (ct, ct2, rlk, mbz),
         lambda v: ctx.mul(ct, ct2, rlk=rlk), None),
        ("square_relin", sq_fn, (ct, rlk, mbz),
         lambda v: ctx.square(ct, rlk=rlk), None),
    ]


def same(got, ref) -> bool:
    return all(g.shape == r.shape and torch.equal(g, r)
               for g, r in zip(as_list(got), as_list(ref)))


def busy_idle(fn, reps: int) -> dict:
    """profiling.busy_idle's row of fn, warmed by one call."""
    fn()
    torch.cuda.synchronize()
    return profiling.busy_idle(fn, reps)[0]


def keystream_at_checks(p: BFVParams, dev) -> None:
    """The draws' device-nonce keystream (kernel 6 at J = 1 on an int64
    nonce on the card, salsa20.keystream_words_batch) against K1 at the
    int nonce, through both maps, at NONCE_EDGES and p's keygen and
    encrypt streams; the draws themselves at a tensor nonce against the
    int nonce."""
    ms = ntt.tables_for(p, device=dev).ms
    for v in NONCE_EDGES:
        t = torch.tensor(np.uint64(v).view(np.int64), device=dev)
        for nbytes, mapped_t, mapped in (
                (sampling.keygen_entropy_bytes(p.n, p.r),
                 sampling.keygen_nonce_t, sampling.keygen_nonce),
                (sampling.encrypt_entropy_bytes(p.n),
                 sampling.encrypt_nonce_t, sampling.encrypt_nonce)):
            nb = -(-nbytes // 64)
            got = salsa20.keystream_words_batch(nb, mapped_t(t).reshape(1),
                                                device=dev)[0]
            if not torch.equal(got, salsa20.keystream_words(
                    nb, nonce=mapped(v), device=dev)):
                raise AssertionError(f"keystream_words_batch at a device "
                                     f"nonce != keystream_words"
                                     f" at nonce {v:#x} ({mapped.__name__})")
        if not (same(sampling.keygen_draws_compact(p.n, p.r, ms, nonce=t),
                     sampling.keygen_draws_compact(p.n, p.r, ms, nonce=v))
                and same(sampling.encrypt_draws_compact(p.n, nonce=t),
                         sampling.encrypt_draws_compact(p.n, nonce=v,
                                                        device=dev))):
            raise AssertionError(f"draws at a tensor nonce != the int nonce "
                                 f"{v:#x}")


def programs_phase(dev, counts: dict) -> None:
    """Phase 16: the op programs captured as CUDA graphs at PROGRAM_SETS
    (full width): each replay equal to the eager public method bit for
    bit, and at a second nonce copied into the static input equal to
    eager there; counts set to 0 before the captures of a set and read
    after them (a replay runs no wrapper, so the captures and their
    warm-up calls are what the counts see); eager and replay event ms,
    kernels a call, busy µs and idle share; then the chained slopes of
    keygen, encrypt and decrypt at STAGE_SET (cli._phase_times) and
    `python -m ntt_cuda_tpu_torch --params STAGE_SET demo --time`."""
    t0 = time.perf_counter()
    card = smi("name,power.limit")
    counts["programs"] = dict.fromkeys(KERNELS, 0)
    v0, v1 = PROGRAM_NONCES
    times = {}
    for name, fusion in PROGRAM_SETS:
        p = get_bfv_params(name)
        keystream_at_checks(p, dev)
        ctx = BFVContext.build(p, fusion=fusion)
        msgs = np.random.default_rng(SEED + 5).integers(0, p.t,
                                                        (BATCH_J, p.n))
        cases = program_cases(ctx, msgs)
        torch.cuda.synchronize()
        reset_counts()
        graphs = [profiling.graphed(fn, *args) for _, fn, args, *_ in cases]
        first = [[t.clone() for t in as_list(g())] for g in graphs]
        torch.cuda.synchronize()
        for k, c in read_counts().items():
            counts["programs"][k] += c
        for (pname, _, args, eager, nonce), g, out in zip(cases, graphs,
                                                          first):
            label = f"{name} {fusion} {pname}"
            if not same(out, eager(v0)):
                raise AssertionError(f"programs {label}: replay != eager")
            if nonce is not None:
                args[0].copy_(nonce(v1))
                if not same(g(), eager(v1)) or same(g.outputs, out):
                    raise AssertionError(f"programs {label}: the replay at "
                                         f"nonce {v1} != eager there, or "
                                         f"== the replay at {v0}")
                args[0].copy_(nonce(v0))
            times[label] = {
                "eager_event_ms": median_ms(lambda: eager(v0), 10),
                "replay_event_ms": median_ms(g, 10),
                "eager": busy_idle(lambda: eager(v0), 30),
                "replay": busy_idle(g, 30)}
        log(f"programs {name} ({fusion}): {len(cases)} programs captured "
            f"once each (profiling.graphed); every replay equals the eager "
            f"public method bit for bit, and keygen, encrypt and "
            f"encrypt_batch replayed at nonce {v1} (copied into the static "
            f"input) equal eager at {v1}; the device-nonce keystream equals "
            f"K1 at nonces {[hex(v) for v in NONCE_EDGES]} through both "
            f"maps")
        del graphs, first
    log(f"launch counts in the programs run (the captures and their "
        f"warm-up calls, both sets): {json.dumps(counts['programs'])}")
    missing = [k for k, (*_, s) in KERNELS.items()
               if "programs" in s and counts["programs"][k] < 1]
    if missing:
        raise AssertionError(f"kernels not launched on the programs path: "
                             f"{missing}")
    log(f"programs, eager against CUDA-graph replay ({card}; event ms: "
        f"median of 10 CUDA-event timings around one call; kernels a call, "
        f"busy us and idle share: torch.profiler over 30 calls, idle = 1 - "
        f"busy / the median synchronised wall time): {json.dumps(times)}")
    ctx_t = BFVContext.build(get_bfv_params(STAGE_SET))
    slopes = dict(zip(("keygen", "encrypt", "decrypt"),
                      (t * 1e6 for t in cli._phase_times(ctx_t,
                                                         ctx_t.params))))
    log(f"chained slopes {STAGE_SET} ({card}; us a step, "
        f"profiling.time_chained: chains of 8 and 64 steps, each a CUDA "
        f"graph): {json.dumps(slopes)}")
    cmd = [sys.executable, "-m", "ntt_cuda_tpu_torch", "--params", STAGE_SET,
           "demo", "--time"]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    for line in proc.stdout.splitlines():
        log(f"  {line}")
    phases = [ln for ln in proc.stdout.splitlines()
              if re.match(r"\[demo\] (keygen |encrypt|decrypt) +[0-9.]+ us$",
                          ln)]
    if proc.returncode != 0 or "PASS" not in proc.stdout or len(phases) != 3:
        raise AssertionError(f"{' '.join(cmd[1:])}: rc {proc.returncode}, "
                             f"stderr {proc.stderr[-2000:]!r}")
    log(f"programs phase: {time.perf_counter() - t0:.1f} s")


# --- phase 17: keygen's fp64 uniform spec, odd t >= 2^31, n = 2^16 and
# 2^17 (the port's last refusals, lifted) ---------------------------------

FP64_SETS = ((OP_SET, "op"), (STAGE_SET, "stage"))
FP64_EDGES = (0, 1, 2**53 - 1, 2**53, 2**53 + 1, 2**63, 2**64 - 1)
WIDE_N, WIDE_R = 32768, 9   # 32k_9q's widths
WIDE_BITS = 57         # the narrowest modulus width at which
#                        make_bfv_params(32768, bits, 9, t) finds nine primes
#                        === 1 mod 2nt for t = find_plain_modulus(32768, 33)
LARGE_SETS = ((16, 16), (17, 4))   # (log2 n, r): make_bfv_params(n, 55, r)


def wide_t_params(top: bool = False) -> BFVParams:
    """32k_9q's widths at an odd t >= 2^31: nine WIDE_BITS-bit moduli ===
    1 mod 2nt for t = find_plain_modulus(32768, 33); with `top`, the same
    moduli with the largest batching prime below 2^62, the port's bound
    (t > q there: every integer is defined, the message does not survive)."""
    t = primegen.find_plain_modulus(WIDE_N, 33)
    p = primegen.make_bfv_params(WIDE_N, WIDE_BITS, WIDE_R, t=t)
    if not top:
        return p
    step = 2 * p.n
    t = (bfv_tail.T_MAX - 1) // step * step + 1
    while not primegen.is_prime(t):
        t -= step
    return BFVParams(name=f"{p.name}_t62", n=p.n, q=p.q, psi=p.psi, t=t)


def narrow_t_params() -> BFVParams:
    """The same widths at the odd t = 65537 (< 2^31): the decrypt kernels'
    Barrett strategy, timed beside the wide one."""
    return primegen.make_bfv_params(WIDE_N, WIDE_BITS, WIDE_R, t=65537)


def path_counts(counts: dict, name: str, run) -> dict:
    """Counts set to 0, `run()` synchronised, its counts added to
    counts[name]; returns run's result."""
    torch.cuda.synchronize()
    reset_counts()
    res = run()
    torch.cuda.synchronize()
    acc = counts.setdefault(name, dict.fromkeys(KERNELS, 0))
    for k, c in read_counts().items():
        acc[k] += c
    return res


def require_launched(counts: dict, name: str) -> None:
    missing = [k for k, (*_, s) in KERNELS.items()
               if name in s and counts[name][k] < 1]
    if missing:
        raise AssertionError(f"kernels not launched on the {name} path: "
                             f"{missing}")
    log(f"launch counts in the {name} run: {json.dumps(counts[name])}")


def fp64_phase(dev, counts: dict) -> dict:
    """keygen with uniform_spec="fp64" at 16k_5q (op) and 32k_9q (stage),
    counted on the "fp64" path: keys equal to the CPU plain path's; the
    fp64 draw (sampling.uniform_ref) on the card at FP64_EDGES equal to the
    host IEEE-double model (golden.uniform_ref_double) at every modulus;
    the keygen program captured as a CUDA graph, its replay equal to
    eager.  Returns eager and replay ms, fp64 beside int."""
    times = {}
    for name, fusion in FP64_SETS:
        p = get_bfv_params(name)
        ctx = BFVContext.build(p, device=dev, uniform_spec="fp64",
                               fusion=fusion)
        sk, pk = path_counts(counts, "fp64", lambda: ctx.keygen(3))
        ref = BFVContext.build(p, device="cpu", uniform_spec="fp64",
                               fusion=fusion).keygen(3)
        if not same((sk.cpu(), pk.cpu()), ref):
            raise AssertionError(f"fp64 keygen {name}: != the CPU plain path")
        u = torch.tensor(np.array(FP64_EDGES, np.uint64).view(np.int64),
                         device=dev).expand(p.r, -1).contiguous()
        got = sampling.uniform_ref(u, ctx.tables_full.ms).cpu().numpy()
        for i, q in enumerate(p.q):
            if got[i].tolist() != golden.uniform_ref_double(FP64_EDGES, q):
                raise AssertionError(f"fp64 draw {name} q_{i}: != the IEEE "
                                     f"double model at {FP64_EDGES}")
        kg_fn, *_, bz = ctx.op_programs()
        nonce = torch.tensor(3, dtype=torch.int64, device=dev)
        g = profiling.graphed(kg_fn, nonce, bz)
        if not same(g(), (sk, pk)):
            raise AssertionError(f"fp64 keygen {name}: replay != eager")
        ctx_int = BFVContext.build(p, device=dev, fusion=fusion)
        times[f"{name} {fusion}"] = {
            "fp64_eager_ms": median_ms(lambda: ctx.keygen(3), 10),
            "fp64_replay_ms": median_ms(g, 10),
            "int_eager_ms": median_ms(lambda: ctx_int.keygen(3), 10),
            "fp64_draw_ms": kernel_ms(lambda: sampling.uniform_ref(
                pk[1], ctx.tables_full.ms)),
            "int_draw_ms": kernel_ms(lambda: sampling.uniform(
                pk[1], ctx.tables_full.ms))}
        log(f"fp64 keygen {name} ({fusion}): keys equal the CPU plain path; "
            f"the draw at {list(FP64_EDGES)} equals the IEEE-double model at "
            f"every modulus; the keygen program's CUDA-graph replay equals "
            f"eager")
    require_launched(counts, "fp64")
    return times


def dec_kernel_cases(p: BFVParams, dev, rng) -> list:
    """(kernel, label, call, plain call, Work) of K2 (J = 1, 3), kernel 15
    (the rule) and kernel 17 (rows 0-3, 6-9 and 0-9, those p has) at p."""
    n, rk = p.n, p.r - 1
    dt = bfv_tail.DecTailConsts.build(p, dev)
    td = ntt.tables_for(p, rk, device=dev)
    cases = []
    for J in (1, 3):
        lead = () if J == 1 else (J,)
        x, c0 = (rand_res(rng, p.q[:rk], n, lead, dev) for _ in range(2))
        cases.append(("decrypt_tail", f"J={J}",
                      lambda x=x, c0=c0: bfv_tail.decrypt_tail(x, c0, dt),
                      lambda x=x, c0=c0: bfv_tail.decrypt_tail_plain(x, c0,
                                                                     dt),
                      decrypt_tail_work(x, c0, dt, J * n)))
    x, sk, c0 = (rand_res(rng, p.q[:rk], n, (), dev) for _ in range(3))
    cases.append(("decrypt_fused", "rule",
                  lambda B=0: bfv_tail.decrypt_fused(x, sk, c0, td, dt,
                                                     cluster=B),
                  lambda: bfv_tail.decrypt_fused_plain(x, sk, c0, td, dt),
                  decrypt_fused_work(x, sk, c0, td, dt)))
    xf, cf = (rand_res(rng, p.q, n, (), dev) for _ in range(2))
    for lo, hi in (b for b in SPMD_BANDS if b[1] <= p.r):
        dc = bfv_tail.build_dec_tail_consts_padded(p, lo, hi, device=dev)
        xs, cs = xf[lo:hi].contiguous(), cf[lo:hi].contiguous()
        cases.append(("decrypt_tail_partial", f"rows {lo}-{hi}",
                      lambda xs=xs, cs=cs, dc=dc:
                          bfv_tail.decrypt_tail_partial(xs, cs, dc),
                      lambda xs=xs, cs=cs, dc=dc:
                          bfv_tail.decrypt_tail_partial_plain(xs, cs, dc),
                      Work(nbytes(xs, cs, dc.k2_rows, dc.glob) + 16 * n,
                           shoup=2 * (hi - lo) * n, mullo=(hi - lo) * n)))
    return cases


def kernel_row(kern, plain, work, mults, clock_hz) -> dict:
    bound_ms, bound_by = work.bound(mults, clock_hz)
    return {"ms": kernel_ms(kern), "us": device_us(kern),
            "plain_ms": kernel_ms(plain, reps=3), "bound_ms": bound_ms,
            "bound_by": bound_by}


def wide_t_phase(dev, counts: dict, errs: dict, mults: dict,
                 clock_hz: float, rng) -> dict:
    """Odd t >= 2^31 at 32k_9q's widths (wide_t_params): K2, 15 (every B)
    and 17 against their plain versions at t = find_plain_modulus(32768,
    33), at the largest batching t below 2^62 and, for the times, at t =
    65537; the "wide_t" path through BFVContext.build(params) (the default
    device, stage): keygen, three messages round-tripped, decrypt_batch,
    encrypt_batch of BATCH_J (rows equal to encrypt), the batching encoder
    (encode, encrypt, decrypt, decode == the slots), keys and ciphertexts
    equal to the CPU plain path; EvalMult refused as the JAX package
    refuses it there (its aux base is too small for such a t); at the
    2^62 t a round trip equal to the CPU plain path; the RNS-sharded
    program at world size 1 over NCCL ("wide_t_spmd": kernels 16-18, x_t's
    all-reduce in 32-bit halves) round-tripping and equal to
    BFVContext's.  Returns per-kernel times."""
    p33, p62, pnarrow = wide_t_params(), wide_t_params(top=True), \
        narrow_t_params()
    times = {}
    for p in (p33, p62, pnarrow):
        for kname, label, kern, plain, work in dec_kernel_cases(p, dev, rng):
            ref = plain()
            compare(kname, kern(), ref, errs)
            if kname == "decrypt_fused":
                for B in (2, 4, 8):
                    compare(kname, kern(B), ref, errs)
            if p is not p62:
                times[f"{kname} {label} t={p.t}"] = kernel_row(
                    kern, plain, work, mults, clock_hz)
        log(f"check K2 (J = 1, 3), 15 (B = rule, 2, 4, 8) and 17 (rows "
            f"{list(SPMD_BANDS)}) at {p.name} t={p.t} (mod-t strategy "
            f"{bfv_tail._t_mode(p.t)}): equal to their plain versions")
    p = p33
    ctx = BFVContext.build(p)
    msgs = np.random.default_rng(SEED + 18).integers(0, p.t, (BATCH_J, p.n),
                                                     dtype=np.uint64)
    msgs[:, :3] = [0, 1, p.t - 1]
    enc = encoder.BatchEncoder(p, dev)
    slots = msgs[0].copy()

    def run():
        res = drive(ctx, msgs[:3])
        sk, pk = res["sk"], res["pk"]
        cts = ctx.encrypt_batch(pk, msgs, list(range(1, BATCH_J + 1)))
        res.update(batch=cts, outb16=ctx.decrypt_batch(sk, cts),
                   plain=enc.encode(slots))
        res["slots"] = enc.decode(ctx.decrypt(sk, ctx.encrypt(
            pk, res["plain"], nonce=99)))
        return res
    res = path_counts(counts, "wide_t", run)
    cpu = BFVContext.build(p, device="cpu")
    check_path(f"{p.name} t={p.t}", res, msgs[:3], drive(cpu, msgs[:3]))
    for j in range(BATCH_J):
        if not torch.equal(res["batch"][j], ctx.encrypt(
                res["pk"], msgs[j], nonce=j + 1)):
            raise AssertionError(f"wide t: encrypt_batch row {j} != encrypt")
    if not np.array_equal(res["outb16"].cpu().numpy().astype(np.uint64),
                          msgs):
        raise AssertionError("wide t: the batch does not round-trip")
    if not (torch.equal(res["plain"].cpu(),
                        encoder.BatchEncoder(p, "cpu").encode(slots))
            and np.array_equal(res["slots"].cpu().numpy().astype(np.uint64),
                               slots)):
        raise AssertionError("wide t: encoder != CPU, or slots lost")
    try:
        behz.AuxBase.build(p)
    except ValueError as e:
        log(f"wide t {p.name}: EvalMult refused, as the JAX package's "
            f"AuxBase refuses it: {e}")
    else:
        raise AssertionError("wide t: the aux base was expected to refuse")
    log(f"wide t path {p.name} t={p.t}: 3 messages round-trip; "
        f"decrypt_batch agrees; keys and ciphertexts equal the CPU plain "
        f"path; encrypt_batch of {BATCH_J} equals encrypt row by row and "
        f"round-trips; the batching encoder equals the CPU's and its slots "
        f"survive encrypt and decrypt")
    require_launched(counts, "wide_t")
    ctx62 = BFVContext.build(p62, device=dev)
    m62 = msgs[:1] % np.uint64(p62.t)
    check_path_unrounded(p62, drive(ctx62, m62),
                         drive(BFVContext.build(p62, device="cpu"), m62))
    log(f"wide t {p62.name} t={p62.t}: keys, ciphertexts and plaintexts "
        f"equal the CPU plain path (t > q: the message does not survive)")
    sctx = spmd.SpmdBFVContext.build(p)

    def run_spmd():
        sk, pk = sctx.keygen(nonce=1)
        cts = [sctx.encrypt(pk, msgs[j], nonce=j + 1) for j in range(2)]
        return sk, pk, cts, [sctx.decrypt(sk, c) for c in cts]
    sk_s, pk_s, cts_s, outs_s = path_counts(counts, "wide_t_spmd", run_spmd)
    for j in range(2):
        if not np.array_equal(outs_s[j].to_local().cpu().numpy().astype(
                np.uint64), msgs[j]):
            raise AssertionError(f"wide t SPMD: message {j} lost")
        if not torch.equal(cts_s[j].to_local()[:, :p.r - 1],
                           res["cts"][j]):
            raise AssertionError(f"wide t SPMD: ciphertext {j} != "
                                 f"BFVContext's")
    log(f"wide t SPMD {p.name} at world size 1 over NCCL: 2 messages "
        f"round-trip, ciphertexts equal BFVContext's")
    require_launched(counts, "wide_t_spmd")
    return times


def check_path_unrounded(p: BFVParams, res: dict, ref: dict) -> None:
    """Keys, ciphertexts and plaintexts equal to `ref` (the CPU's), where
    the message need not survive."""
    for key in ("sk", "pk"):
        if not torch.equal(res[key].cpu(), ref[key].cpu()):
            raise AssertionError(f"{p.name}: {key} != the CPU run")
    for a, b in zip(res["cts"] + res["outs"], ref["cts"] + ref["outs"]):
        if not torch.equal(a.cpu(), b.cpu()):
            raise AssertionError(f"{p.name}: a ciphertext or plaintext != "
                                 f"the CPU run")


def large_n_phase(dev, counts: dict, errs: dict, mults: dict,
                  clock_hz: float, rng) -> dict:
    """n = 2^16 (r = 16) and 2^17 (r = 4), make_bfv_params(n, 55, r): every
    stage row, K2-K5, 15 (every B that fits), 18, the EvalMult kernels and
    the conversions with their bands against their plain versions, K5 and
    18 also at B = 8 (2^16) and B = 16 (2^17, where B = 8 is refused);
    the "large_n" path at 2^16 (stage: keygen, two messages round-tripped,
    decrypt_batch, encrypt_batch of BATCH_J, relin_keygen, mul + relin and
    square + relin), keys and the first ciphertext equal to the CPU plain
    path, the products equal to the exact negacyclic products mod t;
    fusion="op" at 2^16 equal to stage; the "large_n17" path at 2^17
    (keygen equal to the CPU's, a round trip, encrypt_batch of BATCH_J:
    K5 at B = 16); the coefficient-sharded transform at 2^17 over C = 2
    (2^16 a shard).  Returns per-kernel times."""
    times = {}
    for logn, r in LARGE_SETS:
        p = primegen.make_bfv_params(1 << logn, 55, r)
        first = (logn, r) == LARGE_SETS[0]
        try:
            behz.AuxBase.build(p)
            mult = True
        except ValueError:      # 2^17 at r = 4: the aux base refuses, as
            mult = False        # the JAX package's does
        ctx_s = BFVContext.build(p, device=dev, fusion="stage")
        ctx_o = BFVContext.build(p, device=dev, fusion="op")
        timed = {}
        for kname, J, kern, plain, work in (stage_cases(ctx_s, rng, dev)
                                            + op_cases(ctx_o, rng, dev)):
            compare("ntt_transform" if kname in ("ntt_forward",
                                                 "ntt_inverse") else kname,
                    kern(), plain(), errs)
            if J == 1:
                timed.setdefault(kname, (kern, plain, work))
        if mult:
            for kname, J, kern, plain, _ in mult_cases(ctx_s, rng, dev):
                compare(kname, kern(), plain(), errs)
            for J in (1, 2):     # J = 2: 2^17 coefficients a launch and more
                for kname, label, kern, plain, _ in group_cases(p, dev, rng,
                                                                J):
                    compare(kname, kern(), plain(), errs)
        for kname, label, kern, plain, work in dec_kernel_cases(p, dev,
                                                                rng)[2:3]:
            ref = plain()
            for B in CLUSTER_BS:
                if dec_fits(B, p.n):
                    compare(kname, kern(B), ref, errs)
            timed[kname] = (kern, plain, work)
        Bbig = 8 if enc_fits(8, p.n) else 16
        inputs = enc_inputs(ctx_o, rng, 1, dev)
        for B in (0, Bbig):
            for kname, kern, plain in enc_calls(ctx_o, inputs, B):
                compare(kname, kern(), plain(), errs)
        if Bbig == 16:
            for kname, kern, _ in enc_calls(ctx_o, inputs, 8):
                try:
                    kern()
                except RuntimeError:
                    continue
                raise AssertionError(f"{kname} took B = 8 at 2^17")
        pk, u_b, e_d, m = inputs
        timed["encrypt_front"] = (
            lambda: fused_ops.encrypt_front(u_b[0], pk, ctx_o.tables_full),
            lambda: fused_ops.encrypt_front_plain(u_b[0], pk,
                                                  ctx_o.tables_full),
            Work(nbytes(u_b[0], pk, *tables(ctx_o.tables_full), pk),
                 shoup=transform_butterflies(3 * r, p.n) + 2 * r * p.n,
                 mont=2 * r * p.n))
        log(f"check n = 2^{logn} r = {r}: every stage row, K2-K5, 15 "
            f"(B = {[B for B in CLUSTER_BS if dec_fits(B, p.n)]}), 18, "
            f"K5 and 18 at B = {Bbig}"
            + (" (B = 8 refused)" if Bbig == 16 else "")
            + (", the EvalMult kernels, 21a-c, scale_and_round and the "
               "bands (J = 1, 2)" if mult else "")
            + ": equal to their plain versions; the rule's B = "
            f"{ntt_stage.cluster_size(p.n)}")
        for kname in ("ntt_forward", "ntt_inverse_mul", "decrypt_tail",
                      "decrypt_fused", "encrypt_fused", "encrypt_front"):
            kern, plain, work = timed[kname]
            times[f"{kname} n=2^{logn}"] = kernel_row(kern, plain, work,
                                                      mults, clock_hz)
        msgs = np.random.default_rng(SEED + logn).integers(0, p.t,
                                                           (BATCH_J, p.n))
        if first:
            ctx = BFVContext.build(p)
            if ctx.fusion != "stage":
                raise AssertionError("2^16: the rule took op")

            def run():
                res = drive(ctx, msgs[:2])
                res["batch"] = ctx.encrypt_batch(res["pk"], msgs,
                                                 list(range(1, BATCH_J + 1)))
                res["outb16"] = ctx.decrypt_batch(res["sk"], res["batch"])
                res["mult"] = drive_mult(ctx, msgs[:2], dev)
                return res
            res = path_counts(counts, "large_n", run)
            cpu = BFVContext.build(p, device="cpu")
            sk_c, pk_c = cpu.keygen(nonce=1)
            ct_c = cpu.encrypt(pk_c, msgs[0], nonce=1)
            if not same((res["sk"].cpu(), res["pk"].cpu(),
                         res["cts"][0].cpu()), (sk_c, pk_c, ct_c)):
                raise AssertionError("2^16: keys or ciphertext != CPU")
            for j in range(2):
                if not np.array_equal(res["outs"][j].cpu().numpy(), msgs[j]):
                    raise AssertionError(f"2^16: message {j} lost")
            each = torch.stack([ctx.encrypt(res["pk"], msgs[j], nonce=j + 1)
                                for j in range(BATCH_J)])
            if not (torch.equal(res["batch"], each) and np.array_equal(
                    res["outb16"].cpu().numpy(), msgs)):
                raise AssertionError("2^16: encrypt_batch != encrypt, or "
                                     "lost")
            check_mult(p, res["mult"], msgs[:2], dev)
            op = drive(ctx_o, msgs[:2])
            if not same((op["sk"], op["pk"], *op["cts"], *op["outs"]),
                        (res["sk"], res["pk"], *res["cts"], *res["outs"])):
                raise AssertionError("2^16: fusion='op' != stage")
            log(f"large n path 2^16 ({p.name}, stage): keygen, 2 messages "
                f"round-trip, keys and the first ciphertext equal the CPU "
                f"plain path; encrypt_batch of {BATCH_J} equals encrypt and "
                f"round-trips; mul at L = 3, mul + relin and square + relin "
                f"decrypt to the negacyclic products mod t; fusion='op' "
                f"equals stage")
            require_launched(counts, "large_n")
        else:
            ctx = BFVContext.build(p)

            def run17():
                res = drive(ctx, msgs[:2])
                sk, pk = res["sk"], res["pk"]
                cts = ctx.encrypt_batch(pk, msgs, list(range(1, BATCH_J + 1)))
                res["outb16"] = ctx.decrypt_batch(sk, cts)
                return res
            res = path_counts(counts, "large_n17", run17)
            sk_c, pk_c = BFVContext.build(p, device="cpu").keygen(nonce=1)
            if not same((res["sk"].cpu(), res["pk"].cpu()), (sk_c, pk_c)):
                raise AssertionError("2^17: keys != CPU")
            if not (all(np.array_equal(res["outs"][j].cpu().numpy(),
                                       msgs[j]) for j in range(2))
                    and np.array_equal(res["outb16"].cpu().numpy(), msgs)):
                raise AssertionError("2^17: a message was lost")
            log(f"large n path 2^17 ({p.name}, stage): keys equal the CPU "
                f"plain path; 2 messages and an encrypt_batch of {BATCH_J} "
                f"(K5 at B = 16) round-trip")
            require_launched(counts, "large_n17")
            run = coef_path(p, 2, rng, dev, errs)
            if run["counts"]["ntt_transform"] < 1:
                raise AssertionError("coef path 2^17 C = 2: no launch")
            log(f"coef path 2^17 C = 2 (2^16 a shard): every shard's "
                f"launch equals its plain version and the whole transforms; "
                f"launch counts {json.dumps(run['counts'])}")
    return times


def slice_phase(dev, counts: dict, errs: dict, mults: dict,
                clock_hz: float) -> None:
    """Phase 17 (fp64_phase, wide_t_phase, large_n_phase), its times beside
    the card's name and power limit."""
    t0 = time.perf_counter()
    card = smi("name,power.limit")
    rng = np.random.default_rng(SEED + 17)
    fp64 = fp64_phase(dev, counts)
    log(f"fp64 keygen times ({card}; ms: median of 10 CUDA-event timings "
        f"around one call; the draw alone (plain tensor ops): ms per call "
        f"of 20 back to back, CUDA events): "
        f"{json.dumps(fp64)}")
    wide = wide_t_phase(dev, counts, errs, mults, clock_hz, rng)
    log(f"decrypt kernels at odd t ({card}; ms per call of 20 back to "
        f"back, CUDA events, median of 3; us: device time, torch.profiler; "
        f"bound: bytes over {HBM_BYTES_PER_S:.3g} B/s or the multiplies; "
        f"t={narrow_t_params().t} the Barrett strategy, the other t the "
        f"wide one): {json.dumps(wide)}")
    large = large_n_phase(dev, counts, errs, mults, clock_hz, rng)
    log(f"kernels at n = 2^16 (r = 16) and 2^17 (r = 4) ({card}; as "
        f"above; J = 1; K5 and 18 at the rule's B: 8 at 2^16, 16 at "
        f"2^17): {json.dumps(large)}")
    log(f"slice phase (fp64, wide t, large n): "
        f"{time.perf_counter() - t0:.1f} s")


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
    ptxas_out = ptxas_report(ptxas)
    log(f"cluster kernels' registers and spills (ptxas -v, sm_90a; the "
        f"stage kernels, kernel 15's k_decrypt_cluster<CL, OCC>, "
        f"fused_ops.cu's k_op_cluster<CL, OCC, op> and kernel 22's "
        f"k_ntt30_cluster<CL, inverse>, __launch_bounds__ ClusterBound): "
        f"{json.dumps(ptxas_lines(ptxas_out, CLUSTER_KERNELS))}")
    engine_lines = ptxas_lines(ptxas_out, ENGINE_KERNELS)
    log(f"stage engine kernels (k_stage_*<3, 2, PRO>) registers and spills: "
        f"{json.dumps(engine_lines)}; with spills: "
        f"{json.dumps(spills(engine_lines))}")
    if not engine_lines or spills(engine_lines):
        raise AssertionError("the stage engine's kernels spill, or none "
                             "was found")
    group_lines = ptxas_lines(ptxas_out, GROUP_KERNELS)
    log(f"conversion kernels, K2, 17 and the encrypt tail, registers and "
        f"spills (ptxas -v, sm_90a; k_behz<K, which, SHARE> for K = 1..16, "
        f"which 0-3 = 21a, 21b, 21c, scale_and_round; "
        f"k_decrypt_tail<ROWS, PARTIAL>: K2, and 17 with PARTIAL; "
        f"k_encrypt_tail<ROWS, V>): "
        f"{json.dumps(group_lines)}; with spills: "
        f"{json.dumps(spills(group_lines))}")
    salsa_lines = ptxas_lines(ptxas_out, SALSA_KERNEL)
    salsa_o = ROOT / "build" / "ptxas" / "salsa20.o"
    mults["salsa20_block"] = sass_pipes(salsa_o, SALSA_KERNEL)
    mults["gauss_search"] = {"alu": GAUSS_SEARCH_ALU, "fma": 0}
    log(f"K1 and 6 (k_salsa20, k_salsa20_lanes), registers and spills "
        f"(ptxas -v, sm_90a): {json.dumps(salsa_lines)}; with spills: "
        f"{json.dumps(spills(salsa_lines))}; SASS instructions by pipe "
        f"(cuobjdump -sass), k_salsa20 a 64-byte block (the bound's): "
        f"{json.dumps(mults['salsa20_block'])}; k_salsa20_lanes a lane, "
        f"four lanes a block: "
        f"{json.dumps(sass_pipes(salsa_o, SALSA_LANES_KERNEL))}; "
        f"{DRAWS_KERNEL}'s whole SASS (its read-back loops counted once): "
        f"{json.dumps(sass_pipes(salsa_o, DRAWS_KERNEL))}")
    log(f"build: all builds done in {time.perf_counter() - t0:.1f} s")
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
    ks_cases = keystream_checks(dev, errs)
    for label, kname in ((f"keygen {OP_SET}", "salsa20_keystream"),
                         (f"J={BATCH_J} {STAGE_SET}",
                          "salsa20_keystream_batch")):
        timing[kname] = ks_cases[label][2:]
    dr_cases = draws_checks(dev, errs)
    timing["salsa20_draws"] = dr_cases[
        "{} J={}".format(*DRAWS_SHAPES[0])][1:4]
    for name in STAGE_CHECK_SETS + ("32k_16q",):
        ctx = BFVContext.build(get_bfv_params(name), device=dev,
                               fusion="stage")
        for kname, J, kern, plain, work in stage_cases(ctx, rng, dev):
            if name == "32k_16q" and kname != "decrypt_tail":
                continue       # 32k_16q: the decrypt tail at r-1 = 15
            compare("ntt_transform" if kname in ("ntt_forward", "ntt_inverse")
                    else kname, kern(), plain(), errs)
            log(f"check {name} stage {kname} J={J}: equal")
            if name == STAGE_SET and J == 1:   # K2 too: 32k_9q, J = 1
                timing[kname] = (kern, plain, work)
    cluster_checks(dev, rng, errs)
    engine_us = engine_checks(dev, rng, errs)
    log(f"check the stage engine at the server cells' widths (each launch "
        f"counted on the engine, == plain); device us per launch: "
        f"{json.dumps(engine_us)}")
    encrypt_cluster_checks(dev, rng, errs)
    op_cluster_checks(dev, rng, errs)
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
    group_checks(dev, rng, errs)
    timing30 = ntt30_checks(dev, rng, errs)
    r_ops = get_bfv_params(OPS_SET).r
    cases_ops = ops_cases(rng, dev)
    for kname, label, kern, plain, work in cases_ops:
        compare(kname, kern(), plain(), errs)
        log(f"check {kname} {label}: equal")
        if label in (OPS_SET, f"{OPS_SET} permuted B={2 * r_ops + 1} fwd"):
            timing[kname] = (kern, plain, work)
    decrypt_cluster_checks(cases_ops, errs)
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
    for B in CLUSTER_BS:
        compare("decrypt_fused", bfv_tail.decrypt_fused(
            xg, skg, c0g, td4, dt4, cluster=B), mg, errs)
    log(f"golden: dec4k decrypts to i % 10 on the card, op and stage, and "
        f"through kernel 15 (equal to its plain version, and at every "
        f"cluster size B = {list(CLUSTER_BS)})")

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
        if (missing or cnt["salsa20_draws"] != 1
                or cnt["salsa20_keystream_batch"] != 0
                or cnt["encrypt_fused"] != 1):
            raise AssertionError(f"{name} batch path: kernels not launched "
                                 f"{missing}, or k_salsa20_draws / K5 not "
                                 f"once, or kernel 6 launched")
        if name == STAGE_SET:
            counts["batch"] = cnt
        batch[name] = (ctx, res)

    # Phase 7: the op schedule at 32k_9q (K3-K5 one launch each) == stage.
    ctx32, res32, msgs32 = paths["stage"]
    ctx_op32 = BFVContext.build(ctx32.params, fusion="op")
    if ctx_op32.fusion != "op" or ctx_op32.device != dev:
        raise AssertionError(f"{STAGE_SET}: fusion='op' built "
                             f"{ctx_op32.fusion} on {ctx_op32.device}")
    reset_counts()
    res_op32 = drive(ctx_op32, msgs32, dev)
    counts["op32"] = read_counts()
    check_path(f"{STAGE_SET} op vs stage", res_op32, msgs32, res32)
    log(f"main path {STAGE_SET} (op, one cluster launch a transform): 3 "
        f"messages "
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
    for kname, label, kern, plain, work in (
            spmd_cases(p_s, dev, rng) + spmd_mult_cases(p_s, dev, rng)
            + spmd2d_mult_cases(p_s, dev, rng)):
        compare(kname, kern(), plain(), errs)
        log(f"check SPMD {kname} {label}: equal")
        if label in (f"{SPMD_SET} rows 0-{p_s.r}" + (
                " level 0" if kname == "decrypt_tail_partial" else ""),
                     f"{SPMD_SET} rows 0-3 C=2 shard 0"):
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
    # (b''') the 2-D EvalMult (parallel/spmd2d_mult.py) at world size 1
    # over NCCL on (b'')'s keys and ciphertexts, counts read as in 3
    mctx2 = spmd2d_mult.Spmd2DMultContext.build(ctx2)
    torch.cuda.synchronize()
    reset_counts()
    res2m = drive_spmd2d_mult(mctx2, res2)
    counts["spmd2d_mult"] = read_counts()
    check_spmd2d_mult(p_s, res2m["local"], res2m["collectives"], 1, 1, msgs_s,
                      ref_m)
    log(f"2-D EvalMult {SPMD_SET} world size 1 (NCCL, mesh (1, 1)): decrypt3 "
        f"and the relinearized decrypt equal the negacyclic m1 m2 mod t, "
        f"apply_galois({SPMD_GALOIS}) tau_g(m1); relin and Galois keys and "
        f"the live rows of mul, relinearize, mul with rlk and apply_galois "
        f"equal BFVContext.build(params)'s, mul's pad row 0; collectives "
        f"per op {json.dumps(res2m['collectives'])}")
    log(f"launch counts in the 2-D EvalMult run: "
        f"{json.dumps(counts['spmd2d_mult'])}")
    missing = [k for k, (*_, s) in KERNELS.items()
               if "spmd2d_mult" in s and counts["spmd2d_mult"][k] < 1]
    if missing:
        raise AssertionError(f"kernels not launched on the 2-D EvalMult "
                             f"path: {missing}")
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
        colls = got["collectives"]
        check_spmd2d(p_s, local2, {k: colls[k] for k in res2["collectives"]},
                     R2, C2, msgs_s, ref_s)
        check_spmd2d_mult(p_s, local2,
                          {k: colls[k] for k in res2m["collectives"]}, R2, C2,
                          msgs_s, ref_m)
        ws1 = {**res2["local"], **res2m["local"]}
        diff = [k for k, v in ws1.items() if not torch.equal(local2[k], v)]
        if diff or sorted(local2) != sorted(ws1):
            raise AssertionError(f"2-D {R2}x{C2} != world size 1: {diff}")
        for tag, cs in (("spmd2d", got["counts"]),
                        ("spmd2d_mult", got["counts_mult"])):
            lacking = [k for k, (*_, s) in KERNELS.items()
                       if (tag in s or k == "coef_cross_stage")
                       and min(c[k] for c in cs) < 1]
            if lacking:
                raise AssertionError(f"2-D {R2}x{C2} {tag}: kernels not "
                                     f"launched on every rank: {lacking}")
        log(f"2-D {SPMD_SET} {R2}x{C2} (gloo, {R2 * C2} processes on one "
            f"card, blocks ({p_s.r // R2}, {p_s.n // C2})): every tensor "
            f"of the 2-D program and the 2-D EvalMult equals the "
            f"world-size-1 run, padding rows included; collectives per op "
            f"{json.dumps(colls)}; rank 0's launch counts "
            f"{json.dumps(got['counts'][0])}, in the EvalMult "
            f"{json.dumps(got['counts_mult'][0])}")
    # (d) ShardedBFVContext (parallel/rns.py) at world size 1 over NCCL,
    # its gloo runs (R = 3: the SPMD programs; R = 2: `inner`) started
    # first, every output equal to the same calls on BFVContext
    dirs_rns = {R: tempfile.TemporaryDirectory() for R in RNS_RS}
    procs_rns = {R: start_rns_ranks(R, Path(dirs_rns[R].name))
                 for R in RNS_RS}
    ref_rns = drive_rns(ctx32, msgs_s)
    rctx = rns.ShardedBFVContext.build(p_s)   # the default mesh and device
    if rctx.spmd is None or rctx.inner.device != dev or rctx.R != 1:
        raise AssertionError(f"ShardedBFVContext: built on "
                             f"{rctx.inner.device} over {rctx.R} ranks")
    torch.cuda.synchronize()
    reset_counts()
    got_rns = drive_rns(rctx, msgs_s)
    counts["rns"] = read_counts()
    check_rns(p_s, got_rns, ref_rns, msgs_s, "world size 1 (NCCL)")
    log(f"ShardedBFVContext {SPMD_SET} world size 1 (NCCL, the SPMD "
        f"programs): the 16 methods' outputs equal BFVContext.build("
        f"params)'s; the decrypts round-trip and give m1 m2 mod t")
    log(f"launch counts in the ShardedBFVContext run: "
        f"{json.dumps(counts['rns'])}")
    missing = [k for k, (*_, s) in KERNELS.items()
               if "rns" in s and counts["rns"][k] < 1]
    if missing:
        raise AssertionError(f"kernels not launched on the ShardedBFVContext "
                             f"path: {missing}")
    for R, procs in procs_rns.items():
        got = finish_rns_ranks(R, procs, Path(dirs_rns[R].name))
        dirs_rns[R].cleanup()
        sharded_ = p_s.r % R == 0
        if got["sharded"] != [sharded_] * R:
            raise AssertionError(f"ShardedBFVContext R={R}: branch "
                                 f"{got['sharded']}")
        check_rns(p_s, got["got"], ref_rns, msgs_s, f"R={R} (gloo)")
        tag = "rns" if sharded_ else "rns_inner"
        lacking = [k for k, (*_, s) in KERNELS.items()
                   if tag in s and min(c[k] for c in got["counts"]) < 1]
        if lacking:
            raise AssertionError(f"ShardedBFVContext R={R}: kernels not "
                                 f"launched on every rank: {lacking}")
        log(f"ShardedBFVContext {SPMD_SET} R={R} (gloo, {R} processes on "
            f"one card, {'the SPMD programs' if sharded_ else 'inner'}): "
            f"the 16 methods' outputs equal BFVContext.build(params)'s; "
            f"rank 0's launch counts {json.dumps(got['counts'][0])}")
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
    d2m = res2m["dtensor"]
    turns3 = {"stage": [], "spmd2d": []}
    for which, c, (a_, b_, keys) in (
            ("stage", ctx32, (single[2], single[3], ref_m)),
            ("spmd2d", mctx2, (d2["ct0"], d2["ct1"], d2m)),
            ("spmd2d", mctx2, (d2["ct0"], d2["ct1"], d2m)),
            ("stage", ctx32, (single[2], single[3], ref_m))):
        t = mult_turn_times(c, a_, b_, keys, 10)
        t["mul_rlk"] = median_ms(lambda: c.mul(a_, b_, rlk=keys["rlk"]), 10)
        turns3[which].append(t)
    log(f"2-D EvalMult world size 1 against BFVContext at {SPMD_SET} (ms, "
        f"median of CUDA-event timings around one call; turns stage, "
        f"spmd2d, spmd2d, stage; apply_galois of g = {SPMD_GALOIS}): "
        f"{json.dumps(turns3)}")
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
    back_us = {}
    for turn in range(2):
        for label, fn in (
                ("15", lambda: bfv_tail.decrypt_fused(x9, sk9, c09, td9,
                                                      dt9)),
                ("8 + K2", lambda: bfv_tail.decrypt_tail(
                    ntt_stage.ntt_inverse_mul(x9, sk9, td9), c09, dt9))):
            back_us.setdefault(label, []).append(device_us(fn))
    log(f"decrypt back half at {SPMD_SET}, device us per call "
        f"(torch.profiler, turns 15, 8 + K2, 15, 8 + K2): "
        f"{json.dumps(back_us)}")
    log(f"kernel 15 at every cluster size B (device us per call, "
        f"torch.profiler; ms per call of 20 back to back, CUDA events; "
        f"outputs == plain in phase 1): "
        f"{json.dumps(decrypt_cluster_times(cases_ops))}")
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
    log(f"K3 (J = 1) and K4 at every cluster size B (device us per call, "
        f"torch.profiler; ms per call of 20 back to back, CUDA events; "
        f"outputs == plain): {json.dumps(op_cluster_times(dev, rng, errs))}")
    log(f"conversion kernels (21a-c, scale_and_round, the bands) and K2 at "
        f"{GROUP_SETS}, J = 1 (K2 also 3), the launchers' group size, "
        f"device us per call (torch.profiler, two windows of 10 calls; "
        f"scale_and_round also beside 21b then 21c), beside the bound at "
        f"the same shape: "
        f"{json.dumps(group_times(dev, rng, mults, clock_hz))}")
    log(f"K1 and kernel 6 at the main paths' shapes (keygen, encrypt at "
        f"{SALSA_SETS}; relin_keygen, a Galois region, the word-9 carry, "
        f"6 at J = 1 and {BATCH_J} at {STAGE_SET}), each == plain in phase "
        f"1, device us per call (torch.profiler, two windows of 10 calls) "
        f"beside the bound (bytes over {HBM_BYTES_PER_S:.3g} B/s, or the "
        f"busier pipe's SASS instructions over {SMS} SMs x "
        f"{ALU_PER_CLOCK}/clock): "
        f"{json.dumps(keystream_times(ks_cases, mults, clock_hz))}")
    log(f"k_salsa20_draws (encrypt_batch's draws in one launch) at "
        f"{DRAWS_SHAPES} (set, J), each == kernel 6 + the plain converters "
        f"in phase 1, device us per call (torch.profiler, two windows of 10 "
        f"calls) and ms (CUDA events, 20 calls back to back), beside the "
        f"same of the path it replaced and the bound (12 bytes a "
        f"coefficient over {HBM_BYTES_PER_S:.3g} B/s, or K1's rounds a "
        f"block plus {GAUSS_SEARCH_ALU} ALU instructions a Gaussian word "
        f"over {SMS} SMs x {ALU_PER_CLOCK}/clock), {smi('name,power.limit')}: "
        f"{json.dumps(draws_times(dr_cases, mults, clock_hz))}")
    log(f"the encrypt tail's launch forms (K5's and 13's at J = 1 and "
        f"{BATCH_J}, 19's drop, 14, 16 and its drop at rows 0-{p_s.r} and "
        f"6-{p_s.r}) and kernel 17 (rows 0-{p_s.r} and 6-{p_s.r}, levels 0 "
        f"and 1) at {STAGE_SET}, each == plain, device us per call "
        f"(torch.profiler, two windows of 10 calls) beside the bound: "
        f"{json.dumps(tail_times(dev, rng, mults, clock_hz, errs))}")
    bounds, terms = {}, {}
    for kname, (kern, plain, work) in timing.items():
        terms[kname] = work.terms(mults, clock_hz)
        bounds[kname] = (kernel_ms(kern), kernel_ms(plain),
                         *work.bound(mults, clock_hz))
    row_dev = {k: device_us(timing[k][0]) for k in DEVICE_ROWS}
    log(f"stage rows', 14's, 15's and the cross-stage glue's device time "
        f"at the timed shapes (us per call, torch.profiler; 19: its three "
        f"launches; 12: (19, n); the glue: (9, 16384), C = 2): "
        f"{json.dumps(row_dev)}")
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
    compare("encrypt_fused", fused_ops.encrypt_fused(*args),
            fused_ops.encrypt_fused_plain(*args), errs)
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
    log(f"op kernels at {STAGE_SET} (n = 2^15: K3, K4 and K5's transform "
        f"one cluster launch each, K5 then its tail; J = 1, K5 also "
        f"J = {BATCH_J}; "
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
    log(f"kernel 22 at ({NTT30_BATCH}, 1, n) int32 at every cluster size B "
        f"(device us per call, torch.profiler; ms per call of 20 back to "
        f"back, CUDA events; outputs == plain in phase 1): "
        f"{json.dumps(ntt30_cluster_times(timing30))}")
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
    programs_phase(dev, counts)
    slice_phase(dev, counts, errs, mults, clock_hz)
    rows = []
    for kname, (_, source, replaces, scheds) in KERNELS.items():
        ms, plain_ms, bound_ms, bound_by = bounds[kname]
        rows.append({"name": kname, "route": "cuda", "source": source,
                     "replaces": replaces,
                     "launches": (counts[scheds[0]][kname] if scheds
                                  else 0),
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
    if sys.argv[1:2] == ["--rns-worker"]:
        rns_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                   Path(sys.argv[5]))
        sys.exit(0)
    sys.exit(main())
