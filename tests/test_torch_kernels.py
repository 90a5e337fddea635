"""The port's CUDA kernels (ntt_cuda_tpu_torch/csrc) against their plain
tensor versions, exactly (tolerance 0).

Two ways:

* Here, on the CPU: the same .cu sources compiled by g++ as host code,
  once per checkout (`cuda.host_library`; their `#else` branches run each
  block with one thread, in order, where the block barrier is a no-op)
  and called through the same C launchers.
  This checks each kernel's index algebra and arithmetic without a card.
* On the card (`-m gpu`): each wrapper launches its real kernel on CUDA
  tensors.  These tests skip without a card.  Run them on the card with
  `python -m pytest --noconftest -p no:cacheprovider -m gpu
  tests/test_torch_kernels.py` (the suite's conftest imports jax, which
  a CUDA-only environment need not have).
"""

import functools
import re

import numpy as np
import pytest
import torch

from ntt_cuda_tpu_torch import cuda, get_bfv_params
from ntt_cuda_tpu_torch.models.bfv import BFVContext
from ntt_cuda_tpu_torch.ops import (behz, behz_kernels, bfv_tail, fused_ops,
                                    modmath, ntt, ntt30, ntt_stage, poly,
                                    salsa20, sampling)
from ntt_cuda_tpu_torch.parallel import coef_kernels, sharded
from ntt_cuda_tpu_torch.params import BFVParams, get_params
from ntt_cuda_tpu_torch.utils import primegen

# A 1024-point set with three 40-bit moduli (generated like
# ntt_cuda_tpu.utils.primegen.make_bfv_params(1024, 40, 3)), and the same
# ring with an odd batching-prime t for the Barrett-by-t decrypt path.
SMALL = BFVParams(name="gen_1024_40b_3q", n=1024,
                  q=(1099511592961, 1099511590913, 1099511560193),
                  psi=(725937910219, 657951260720, 482200140313))
SMALL_ODD_T = BFVParams(name="gen_1024_40b_3q_t12289", n=1024,
                        q=(1099181641729, 1098929963009, 1098653116417),
                        psi=(54196767100, 970723731015, 1029154110237),
                        t=12289)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in
    several worker processes at once, and oversubscribed torch threads slow
    the 32k plain transforms by two orders of magnitude."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rand_res(rng, qs, n, lead=()):
    return torch.from_numpy(np.stack(
        [rng.integers(0, q, lead + (n,), dtype=np.int64) for q in qs],
        axis=-2))


@pytest.fixture(scope="module")
def host_lib():
    """csrc/*.cu built as host C++, once per checkout (cuda.host_library)."""
    try:
        return cuda.host_library()
    except cuda.NoHostCompiler as e:
        pytest.skip(str(e))


def test_host_library_is_built_once_per_checkout(host_lib):
    """Every call of cuda.host_library() in a process returns the one
    handle, loaded from the hash-keyed directory beside the card's."""
    assert cuda.host_library() is host_lib
    built = cuda.CSRC.parents[1] / "build" / f"host-{cuda.host_hash()}"
    assert host_lib._name == str(built / "libntt_cuda_tpu_torch.so")
    assert (built / "libntt_cuda_tpu_torch.so").is_file()


def test_host_and_card_builds_hash_apart():
    """The compiler flags are part of each build's key: the host and card
    libraries never share a directory."""
    assert cuda.HOST_FLAGS != cuda.NVCC_FLAGS
    assert cuda.host_hash() != cuda.source_hash()
    assert len(cuda.host_hash()) == len(cuda.source_hash()) == 16


@pytest.fixture(scope="module", params=[SMALL, get_bfv_params("4k_3q")],
                ids=lambda p: p.name)
def ctx(request):
    return BFVContext.build(request.param, device="cpu")


# The stage kernels also at 32k_9q: the only check of the 2^15 split (an
# elementwise stage-0 pass beside two 2^14 halves) before the card.
@pytest.fixture(scope="module",
                params=[SMALL, get_bfv_params("4k_3q"),
                        get_bfv_params("32k_9q")], ids=lambda p: p.name)
def stage_ctx(request):
    return BFVContext.build(request.param, device="cpu", fusion="stage")


# blocks of a launch on either side of the launcher's rule (SALSA_LANES_BELOW
# = 8192 in csrc/salsa20.cu): four lanes a block below it, the staged
# 64-block tile from it (8269 leaves a partial last tile)
SALSA_NBS = {"lanes": 300, "tile": 8269}


@pytest.mark.parametrize("form", SALSA_NBS)
@pytest.mark.parametrize("nonce,ctr0", [(0, 0), (7 | (1 << 63), 0),
                                       (3, 2**32 - 5)],
                         ids=["zero", "nonce_bit63", "word9_carry"])
def test_host_salsa20(host_lib, nonce, ctr0, form):
    """K1: the stream in byte order as u32 words, equal to the plain
    version, in both of the launcher's forms, at the (nonce, counter0)
    edges: 0, the nonce's bit 63 and a counter0 whose blocks cross into
    word 9."""
    nb = SALSA_NBS[form]
    ks = torch.full((16 * nb + 16,), 7, dtype=torch.int32)
    assert host_lib.ntt_salsa20(ks.data_ptr(), nb, 0x01010101, nonce, ctr0,
                                None) == 0
    ref = salsa20.keystream_words_plain(nb, nonce=nonce, counter0=ctr0)
    torch.testing.assert_close(ks[:16 * nb], ref, rtol=0, atol=0)
    assert torch.all(ks[16 * nb:] == 7)          # nothing past the stream
    assert host_lib.ntt_salsa20(ks.data_ptr(), 0, 0x01010101, nonce, ctr0,
                                None) != 0


@pytest.mark.parametrize("nb", [300, 2069], ids=["lanes", "tile"])
def test_host_salsa20_batch(host_lib, nb):
    """Kernel 6: J nonces' streams in one launch, row j nonce j's stream,
    nonces >= 2^63 read as u64 bit patterns, counter0's carry into word 9;
    4 x 2069 blocks take the staged tile, each row ending in a partial
    one."""
    nonces = [0, 1, 2**62 + 5, 7 | (1 << 63)]
    v = salsa20.nonce_tensor(nonces, "cpu")
    for ctr0 in (0, 2**32 - 5):
        ks = torch.empty((len(nonces), 16 * nb), dtype=torch.int32)
        assert host_lib.ntt_salsa20_batch(ks.data_ptr(), nb, 0x01010101,
                                          v.data_ptr(), len(nonces), ctr0,
                                          None) == 0
        ref = salsa20.keystream_words_batch_plain(nb, nonces, counter0=ctr0)
        torch.testing.assert_close(ks, ref, rtol=0, atol=0)
        for j, nonce in enumerate(nonces):
            torch.testing.assert_close(
                ks[j], salsa20.keystream_words_plain(nb, nonce=nonce,
                                                     counter0=ctr0),
                rtol=0, atol=0)
    assert host_lib.ntt_salsa20_batch(ks.data_ptr(), nb, 0, v.data_ptr(), 0,
                                      0, None) != 0


# the draws kernel's nonce edges: 0 (no bit 63), bits 32-62 set, the
# largest user nonce, and one with bit 63 already set (mapped to itself)
DRAW_NONCES = [0, 0x7FFFFFFF00000000 | 5, 2**63 - 1, 7 | (1 << 63), 1]


@pytest.mark.parametrize("n", [64, 1024, 4096])
def test_host_salsa20_draws(host_lib, n):
    """k_salsa20_draws (host build): u_b and e_d equal kernel 6's plain
    stream of the mapped nonces followed by the plain converters, the
    nonces given raw; n = 1024 leaves a partial last tile (144 blocks a
    stream) and a tile that holds ternary and Gaussian blocks both (n =
    64); nothing is written past the outputs."""
    J = len(DRAW_NONCES)
    v = salsa20.nonce_tensor(DRAW_NONCES, "cpu")
    u_b = torch.full((J + 1, n), 7, dtype=torch.int32)
    e_d = torch.full((J + 1, 2, n), 7, dtype=torch.int32)
    assert host_lib.ntt_salsa20_draws(u_b.data_ptr(), e_d.data_ptr(), n,
                                      0x01010101, v.data_ptr(), J, None) == 0
    ks = salsa20.keystream_words_batch_plain(
        sampling.encrypt_entropy_bytes(n) // 64,
        sampling.encrypt_nonces(DRAW_NONCES))
    assert torch.equal(u_b[:J], sampling.ternary_int(
        salsa20.bytes_u8(ks, 0, n)))
    assert torch.equal(e_d[:J], sampling.gaussian_int(
        salsa20.bytes_u32(ks, n, 2 * n).reshape(J, 2, n)))
    ref = sampling.encrypt_draws_compact_batch(n, DRAW_NONCES, device="cpu")
    assert torch.equal(u_b[:J], ref[0]) and torch.equal(e_d[:J], ref[1])
    assert torch.all(u_b[J] == 7) and torch.all(e_d[J] == 7)


@pytest.mark.parametrize("n,J", [(32, 1), (1000, 1), (0, 1), (1024, 0)])
def test_host_salsa20_draws_refusals(host_lib, n, J):
    """n not a multiple of 64 (or below it) and J = 0 are refused."""
    v = salsa20.nonce_tensor([1], "cpu")
    out = torch.empty(3 * 1024, dtype=torch.int32)
    assert host_lib.ntt_salsa20_draws(out.data_ptr(), out.data_ptr(), n,
                                      0x01010101, v.data_ptr(), J, None) != 0


def _draws_convert(host_lib, words):
    """The draws kernel's converters on given u32 words (host seam)."""
    w = torch.from_numpy(np.asarray(words, dtype=np.uint64).astype(
        np.uint32).view(np.int32).copy())
    tern = torch.empty(4 * w.numel(), dtype=torch.int32)
    gauss = torch.empty(w.numel(), dtype=torch.int32)
    assert host_lib.ntt_draws_convert(w.data_ptr(), w.numel(),
                                      tern.data_ptr(), gauss.data_ptr()) == 0
    return w, tern, gauss


def test_host_draws_converters_at_the_edges(host_lib):
    """The draws kernel's Gaussian search and ternary division on given
    words equal gaussian_int and ternary_int: every bound and bound - 1,
    the words 0, 1, 2^32 - 129, 2^32 - 128 and 2^32 - 1, random words, and
    the bytes 0, 84, 85, 169, 170, 254 and 255 in every byte position."""
    bounds = sampling.GAUSS_ICDF_BOUNDS
    edge_bytes = [0, 84, 85, 169, 170, 254, 255]
    words = ([b for b in bounds] + [b - 1 for b in bounds]
             + [0, 1, 2**32 - 129, 2**32 - 128, 2**32 - 1]
             + [int.from_bytes(bytes(edge_bytes[k:] + edge_bytes[:k])[:4],
                               "little") for k in range(len(edge_bytes))]
             + np.random.default_rng(5).integers(0, 2**32, 4096).tolist())
    w, tern, gauss = _draws_convert(host_lib, words)
    assert torch.equal(gauss, sampling.gaussian_int(w))
    assert torch.equal(tern, sampling.ternary_int(w.view(torch.uint8)))
    assert sorted(set(tern.tolist())) == [-1, 0, 1, 2]
    assert gauss.min() == -19 and gauss.max() == 16


def test_draws_gauss_table_is_the_pinned_spec():
    """csrc/salsa20.cu's GAUSS_TABLE is ops/sampling.py's
    GAUSS_ICDF_BOUNDS, in order."""
    src = (cuda.CSRC / "salsa20.cu").read_text()
    body = src[src.index("#define GAUSS_TABLE"):].split("}", 1)[0]
    table = tuple(int(x) for x in re.findall(r"(\d+)u", body))
    assert table == sampling.GAUSS_ICDF_BOUNDS
    assert f"#define GAUSS_BOUNDS {len(table)}" in src


@pytest.fixture(scope="module")
def op32_ctx():
    return BFVContext.build(get_bfv_params("32k_9q"), device="cpu",
                            fusion="op")


def _enc_inputs(ctx, rng, J):
    """K5's inputs for J messages: pk, compact draws of nonces 1..J and
    messages with the Delta*m + fix boundaries."""
    p = ctx.params
    _, pk = ctx.keygen(nonce=1)
    u_b, e_d = sampling.encrypt_draws_compact_batch(p.n, range(1, J + 1),
                                                    device=ctx.device)
    m = torch.from_numpy(rng.integers(0, p.t, (J, p.n), dtype=np.int64))
    m[:, :4] = torch.tensor([0, p.t - 1, p.t // 2, p.t // 2 - 1])
    return pk.to(ctx.device), u_b, e_d, m.to(ctx.device)


def _host_encrypt(host_lib, ctx, u_b, pk, e_d, m):
    p, tc = ctx.params, ctx.tail_consts
    J = u_b.shape[0]
    scratch = torch.empty((J, 2, p.r, p.n), dtype=torch.int64)
    ct = torch.empty((J, 2, p.r - 1, p.n), dtype=torch.int64)
    assert host_lib.ntt_encrypt_transform_cluster(
        u_b.data_ptr(), pk.data_ptr(), e_d.data_ptr(), scratch.data_ptr(),
        *ctx.tables_full.kernel_args(), J, p.r, p.logn, 0, None) == 0
    assert host_lib.ntt_encrypt_tail(scratch.data_ptr(), m.data_ptr(),
                                     ct.data_ptr(), tc.tail_rows.data_ptr(),
                                     tc.q_last, tc.half, tc.fix_th, J, p.r,
                                     p.n, None) == 0
    return ct


@pytest.mark.parametrize("J", [1, 2])
def test_host_op_kernels_32k(host_lib, op32_ctx, J):
    """K3, K4 and K5 at n = 2^15 (32k_9q constants) against the plain
    versions, each one cluster launch per polynomial at the launchers' B
    (K5 then its tail)."""
    ctx = op32_ctx
    p, tf, td = ctx.params, ctx.tables_full, ctx.tables_drop
    rng = np.random.default_rng(100 + J)
    x = _rand_res(rng, p.q[:-1], p.n, (J,))
    y = _rand_res(rng, p.q[:-1], p.n)
    out = torch.empty_like(x)
    assert host_lib.ntt_half_polymul_cluster(x.data_ptr(), y.data_ptr(),
                                             out.data_ptr(), *td.kernel_args(),
                                             J * td.r, td.r, p.logn, 0,
                                             None) == 0
    torch.testing.assert_close(out, fused_ops.half_polymul_plain(x, y, td),
                               rtol=0, atol=0)
    s_b, a, e_d = sampling.keygen_draws_compact(p.n, p.r, tf.ms, nonce=J)
    sk, pk0 = torch.empty_like(a), torch.empty_like(a)
    assert host_lib.ntt_keygen_fused_cluster(s_b.data_ptr(), a.data_ptr(),
                                             e_d.data_ptr(), sk.data_ptr(),
                                             pk0.data_ptr(), *tf.kernel_args(),
                                             p.r, p.logn, 0, None) == 0
    for got, ref in zip((sk, pk0), fused_ops.keygen_fused_plain(s_b, a, e_d,
                                                                 tf)):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
    pk, u_b, e_d, m = _enc_inputs(ctx, rng, J)
    torch.testing.assert_close(
        _host_encrypt(host_lib, ctx, u_b, pk, e_d, m),
        fused_ops.encrypt_fused_plain(u_b, pk, e_d, m, tf, ctx.tail_consts),
        rtol=0, atol=0)


def test_host_op_kernels_reject_bad_arguments(host_lib, op32_ctx):
    p, tf = op32_ctx.params, op32_ctx.tables_full
    x = torch.zeros((p.r, p.n), dtype=torch.int64)
    for blocks, logn in ((p.r + 1, p.logn), (p.r, 18), (p.r, 0)):
        assert host_lib.ntt_half_polymul_cluster(
            x.data_ptr(), x.data_ptr(), x.data_ptr(), *tf.kernel_args(),
            blocks, p.r, logn, 0, None) != 0
    assert host_lib.ntt_encrypt_transform_cluster(
        None, None, None, None, *tf.kernel_args(), 0, p.r, p.logn, 0,
        None) != 0


@pytest.mark.parametrize("J", [1, 3])
def test_host_half_polymul(host_lib, ctx, J):
    p = ctx.params
    rng = np.random.default_rng(J)
    tb = ctx.tables_drop
    x = _rand_res(rng, p.q[:-1], p.n, (J,))
    y = _rand_res(rng, p.q[:-1], p.n)
    out = torch.empty_like(x)
    assert host_lib.ntt_half_polymul_cluster(x.data_ptr(), y.data_ptr(),
                                             out.data_ptr(), *tb.kernel_args(),
                                             J * tb.r, tb.r, p.logn, 0,
                                             None) == 0
    ref = fused_ops.half_polymul_plain(x, y, tb)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


@pytest.mark.parametrize("nonce", [0, 5])
def test_host_keygen_fused(host_lib, ctx, nonce):
    p = ctx.params
    s_b, a, e_d = sampling.keygen_draws_compact(p.n, p.r, ctx.tables_full.ms,
                                                nonce=nonce)
    sk = torch.empty_like(a)
    pk0 = torch.empty_like(a)
    assert host_lib.ntt_keygen_fused_cluster(
        s_b.data_ptr(), a.data_ptr(), e_d.data_ptr(), sk.data_ptr(),
        pk0.data_ptr(), *ctx.tables_full.kernel_args(), p.r, p.logn, 0,
        None) == 0
    sk_ref, pk0_ref = fused_ops.keygen_fused_plain(s_b, a, e_d,
                                                   ctx.tables_full)
    torch.testing.assert_close(sk, sk_ref, rtol=0, atol=0)
    torch.testing.assert_close(pk0, pk0_ref, rtol=0, atol=0)


@pytest.mark.parametrize("J", [1, 3])
def test_host_encrypt_fused(host_lib, ctx, J):
    p = ctx.params
    rng = np.random.default_rng(10 + J)
    _, pk = ctx.keygen(nonce=1)
    draws = [sampling.encrypt_draws_compact(p.n, nonce=k + 1, device="cpu")
             for k in range(J)]
    u_b = torch.stack([d[0] for d in draws])
    e_d = torch.stack([d[1] for d in draws])
    m = torch.from_numpy(rng.integers(0, p.t, (J, p.n), dtype=np.int64))
    m[:, :4] = torch.tensor([0, p.t - 1, p.t // 2, p.t // 2 - 1])
    scratch = torch.empty((J, 2, p.r, p.n), dtype=torch.int64)
    ct = torch.empty((J, 2, p.r - 1, p.n), dtype=torch.int64)
    tc = ctx.tail_consts
    assert host_lib.ntt_encrypt_transform_cluster(
        u_b.data_ptr(), pk.data_ptr(), e_d.data_ptr(), scratch.data_ptr(),
        *ctx.tables_full.kernel_args(), J, p.r, p.logn, 0, None) == 0
    assert host_lib.ntt_encrypt_tail(scratch.data_ptr(), m.data_ptr(),
                                     ct.data_ptr(), tc.tail_rows.data_ptr(),
                                     tc.q_last, tc.half, tc.fix_th, J, p.r,
                                     p.n, None) == 0
    ref = fused_ops.encrypt_fused_plain(u_b, pk, e_d, m, ctx.tables_full, tc)
    torch.testing.assert_close(ct, ref, rtol=0, atol=0)


# K5's transform and kernel 18 through the entry points that take the
# cluster size B (0: the rule): every B at 32k_9q (J = 1 and 2) and at
# 4k_3q (J = 3).  A block holds two n/B buffers, so B = 1 and 2 at 2^15
# must be refused.
ENC_SETS = [("32k_9q", 1), ("32k_9q", 2), ("4k_3q", 3)]
ENC_BS = [0, 1, 2, 4, 8]


def _enc_takes(B, n):
    """Whether the encrypt launchers take cluster size B at n points: two
    n/B u64 buffers in at most 2^14 u64 (128 KB) a block."""
    return B == 0 or (2 <= n // B and 2 * n // B <= 16384)


# set -> K5's inputs (a random pk) for the set's largest J and the three
# plain results: the ciphertexts, the transform's scratch, kernel 18's c for
# message 0.  Message j's inputs do not depend on J, so a case of J
# messages takes the first J of each.
_ENC = {}


def _enc_case(ctx, J):
    p = ctx.params
    if p.name not in _ENC:
        Jm = max(j for name, j in ENC_SETS if name == p.name)
        rng = np.random.default_rng(60)
        pk = _rand_res(rng, p.q, p.n, (2,))
        u_b, e_d = sampling.encrypt_draws_compact_batch(p.n, range(1, Jm + 1),
                                                        device="cpu")
        m = torch.from_numpy(rng.integers(0, p.t, (Jm, p.n), dtype=np.int64))
        m[:, :4] = torch.tensor([0, p.t - 1, p.t // 2, p.t // 2 - 1])
        tf = ctx.tables_full
        _ENC[p.name] = ((pk, u_b, e_d, m), (
            fused_ops.encrypt_fused_plain(u_b, pk, e_d, m, tf,
                                          ctx.tail_consts),
            fused_ops.encrypt_transform_plain(u_b, pk, e_d, tf),
            fused_ops.encrypt_front_plain(u_b[0], pk, tf)))
    (pk, u_b, e_d, m), (ct, scratch, c) = _ENC[p.name]
    return (pk, u_b[:J], e_d[:J], m[:J]), (ct[:J], scratch[:J], c)


@pytest.mark.parametrize("B", ENC_BS, ids=lambda B: f"B{B}")
@pytest.mark.parametrize("name,J", ENC_SETS, ids=lambda x: str(x))
def test_host_encrypt_cluster(host_lib, op32_ctx, name, J, B):
    """K5 (its transform's scratch, then the tail's ciphertexts) and
    kernel 18 (message 0, all r moduli) at cluster size B against their
    plain versions, exactly; a B whose two buffers do not fit a block is
    refused."""
    ctx = op32_ctx if name == op32_ctx.params.name else BFVContext.build(
        get_bfv_params(name), device="cpu", fusion="op")
    (pk, u_b, e_d, m), (ref_ct, ref_scratch, ref_c) = _enc_case(ctx, J)
    p, tf, tc = ctx.params, ctx.tables_full, ctx.tail_consts
    scratch = torch.empty((J, 2, p.r, p.n), dtype=torch.int64)
    c = torch.empty((2, p.r, p.n), dtype=torch.int64)
    rc = host_lib.ntt_encrypt_transform_cluster(
        u_b.data_ptr(), pk.data_ptr(), e_d.data_ptr(), scratch.data_ptr(),
        *tf.kernel_args(), J, p.r, p.logn, B, None)
    rc_front = host_lib.ntt_encrypt_front_cluster(
        u_b[0].data_ptr(), pk.data_ptr(), c.data_ptr(), *tf.kernel_args(),
        p.r, p.logn, B, None)
    if not _enc_takes(B, p.n):
        assert rc != 0 and rc_front != 0
        return
    assert rc == 0 and rc_front == 0
    torch.testing.assert_close(scratch, ref_scratch, rtol=0, atol=0)
    ct = torch.empty((J, 2, p.r - 1, p.n), dtype=torch.int64)
    assert host_lib.ntt_encrypt_tail(scratch.data_ptr(), m.data_ptr(),
                                     ct.data_ptr(), tc.tail_rows.data_ptr(),
                                     tc.q_last, tc.half, tc.fix_th, J, p.r,
                                     p.n, None) == 0
    torch.testing.assert_close(ct, ref_ct, rtol=0, atol=0)
    torch.testing.assert_close(c, ref_c, rtol=0, atol=0)


def test_host_encrypt_cluster_refusals(host_lib):
    """The encrypt launchers refuse, before touching memory, the shapes
    whose two n/B buffers pass 128 KB a block (2^14 at B = 1, 2^15 at B =
    1 and 2, 2^17 at B = 8), a B that is no power of two up to 8 (16 only
    where 8 does not fit: 2^17), and n past 2^17; the rule (B = 0) is
    taken from n = 2 to 2^15."""
    front = host_lib.ntt_encrypt_front_cluster
    tf = [None] * 5
    for logn, B in ((14, 1), (15, 1), (15, 2), (15, 3), (15, 16), (18, 0),
                    (17, 8), (0, 0)):
        assert front(None, None, None, *tf, 1, logn, B, None) != 0, (logn, B)
        assert host_lib.ntt_encrypt_transform_cluster(
            None, None, None, None, *tf, 1, 1, logn, B, None) != 0, (logn, B)
    q = SMALL.q[0]
    for n in (2, 16, 1024):    # the rule's B: 1, 8, 8
        psi = pow(SMALL.psi[0], SMALL.n // n, q)
        tb = ntt.NTTTables.build([q], [psi], n, device="cpu")
        u = torch.from_numpy(np.resize(np.array([1, -1, 0], np.int32), n))
        pk = _rand_res(np.random.default_rng(n), SMALL.q[:1], n, (2,))
        c = torch.empty_like(pk)
        assert front(u.data_ptr(), pk.data_ptr(), c.data_ptr(),
                     *tb.kernel_args(), 1, n.bit_length() - 1, 0, None) == 0
        torch.testing.assert_close(c, fused_ops.encrypt_front_plain(u, pk, tb),
                                   rtol=0, atol=0)


# K3 (J = 1 and 3 messages over the set's first r-1 moduli, decrypt's
# shape) and K4 through the entry points that take the cluster size B, at
# every B at three sets.  A block holds one n/B buffer (_takes), so only
# B = 1 at 2^15 must be refused.
OP_SETS = ["4k_3q", "16k_5q", "32k_9q"]
OP_BS = [1, 2, 4, 8]
OP_KERNELS = ["K3-J1", "K3-J3", "K4"]

# set -> the tables of K3 (r-1 moduli) and K4 (r), K3's x (3, r-1, n) and
# y with half_polymul_plain of x, and K4's draws (nonce 7) with
# keygen_fused_plain; a case of J messages takes the first J rows of x.
_OPS = {}


def _op_case(name):
    if name not in _OPS:
        p = get_bfv_params(name)
        rng = np.random.default_rng(70)
        td = ntt.tables_for(p, p.r - 1, device="cpu")
        tf = ntt.tables_for(p, device="cpu")
        x = _rand_res(rng, p.q[:-1], p.n, (3,))
        y = _rand_res(rng, p.q[:-1], p.n)
        s_b, a, e_d = sampling.keygen_draws_compact(p.n, p.r, tf.ms, nonce=7)
        _OPS[name] = (p, td, tf,
                      (x, y, fused_ops.half_polymul_plain(x, y, td)),
                      (s_b, a, e_d,
                       fused_ops.keygen_fused_plain(s_b, a, e_d, tf)))
    return _OPS[name]


@pytest.mark.parametrize("B", OP_BS, ids=lambda B: f"B{B}")
@pytest.mark.parametrize("name", OP_SETS)
@pytest.mark.parametrize("kernel", OP_KERNELS)
def test_host_op_cluster(host_lib, kernel, name, B):
    """K3 or K4 at cluster size B against its plain version, exactly; a B
    whose n/B buffer does not fit a block (1 at 2^15) is refused."""
    p, td, tf, (x, y, ref_x), (s_b, a, e_d, ref_k) = _op_case(name)
    if kernel == "K4":
        sk, pk0 = torch.empty_like(a), torch.empty_like(a)
        rc = host_lib.ntt_keygen_fused_cluster(
            s_b.data_ptr(), a.data_ptr(), e_d.data_ptr(), sk.data_ptr(),
            pk0.data_ptr(), *tf.kernel_args(), p.r, p.logn, B, None)
        got, ref = (sk, pk0), ref_k
    else:
        J = int(kernel[-1])
        out = torch.empty_like(x[:J])
        rc = host_lib.ntt_half_polymul_cluster(
            x.data_ptr(), y.data_ptr(), out.data_ptr(), *td.kernel_args(),
            J * td.r, td.r, p.logn, B, None)
        got, ref = (out,), (ref_x[:J],)
    if not _takes(B, p.n):
        assert rc != 0
        return
    assert rc == 0
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=0)


def test_host_op_cluster_refusals(host_lib):
    """K3 and K4 refuse, before touching memory, a B that is no power of
    two up to 8 (3, 16: one buffer a block never takes 16), n outside
    [2, 2^17] (logn 0 and 18), B = 1 at 2^15, no polynomial or modulus,
    and (K3) a polynomial count that is no multiple of r; the rule (B = 0)
    is taken from n = 2 to 2^15."""
    k3 = host_lib.ntt_half_polymul_cluster
    k4 = host_lib.ntt_keygen_fused_cluster
    tf = [None] * 5
    for logn, B in ((14, 3), (15, 16), (15, 1), (0, 0), (0, 1), (18, 0),
                    (17, 16)):
        assert k3(None, None, None, *tf, 2, 1, logn, B, None) != 0, (logn, B)
        assert k4(None, None, None, None, None, *tf, 1, logn, B,
                  None) != 0, (logn, B)
    for P, r in ((4, 3), (0, 3), (3, 0)):
        assert k3(None, None, None, *tf, P, r, 12, 0, None) != 0, (P, r)
    assert k4(None, None, None, None, None, *tf, 0, 12, 0, None) != 0
    q = SMALL.q[0]
    rng = np.random.default_rng(71)
    for n in (2, 16, 1024):    # the rule's B: 1, 8, 8
        psi = pow(SMALL.psi[0], SMALL.n // n, q)
        tb = ntt.NTTTables.build([q], [psi], n, device="cpu")
        x, y, a = (_rand_res(rng, SMALL.q[:1], n, (2,)) for _ in range(3))
        a = a[0].contiguous()
        out = torch.empty_like(x)
        assert k3(x.data_ptr(), y[0].data_ptr(), out.data_ptr(),
                  *tb.kernel_args(), 2, 1, n.bit_length() - 1, 0, None) == 0
        torch.testing.assert_close(
            out, fused_ops.half_polymul_plain(x, y[0], tb), rtol=0, atol=0)
        s_b = torch.from_numpy(np.resize(np.array([1, -1, 0], np.int32), n))
        e_d = torch.from_numpy(rng.integers(-19, 17, n).astype(np.int32))
        sk, pk0 = torch.empty_like(a), torch.empty_like(a)
        assert k4(s_b.data_ptr(), a.data_ptr(), e_d.data_ptr(), sk.data_ptr(),
                  pk0.data_ptr(), *tb.kernel_args(), 1, n.bit_length() - 1, 0,
                  None) == 0
        for g, r in zip((sk, pk0), fused_ops.keygen_fused_plain(s_b, a, e_d,
                                                                tb)):
            torch.testing.assert_close(g, r, rtol=0, atol=0)


def _host_decrypt_tail(host_lib, x, c0, dt):
    J, rk, n = x.shape
    out = torch.empty((J, n), dtype=torch.int64)
    rc = host_lib.ntt_decrypt_tail(
        x.data_ptr(), c0.data_ptr(), out.data_ptr(), dt.k2_rows.data_ptr(),
        dt.glob.data_ptr(), J, rk, n, *bfv_tail._t_strategy(dt.tmeta), None)
    return rc, out


@pytest.mark.parametrize("params", [SMALL, SMALL_ODD_T], ids=["pow2_t",
                                                              "odd_t"])
@pytest.mark.parametrize("J", [1, 3])
def test_host_decrypt_tail(host_lib, params, J):
    """K2, the residue rows of a coefficient summed by the G members of
    the launchers' rule and added as the kernel's shuffles add them."""
    p = params
    rng = np.random.default_rng(20 + J)
    dt = bfv_tail.DecTailConsts.build(p)
    x = _rand_res(rng, p.q[:-1], p.n, (J,))
    c0 = _rand_res(rng, p.q[:-1], p.n, (J,))
    # the strict-`>` boundary: x + c0 == q exactly stays unreduced
    for i, q in enumerate(p.q[:-1]):
        x[:, i, :3] = torch.tensor([q - 1, 0, 5])
        c0[:, i, :3] = torch.tensor([1, 0, q - 5])
    rc, out = _host_decrypt_tail(host_lib, x, c0, dt)
    assert rc == 0
    torch.testing.assert_close(out, bfv_tail.decrypt_tail_plain(x, c0, dt),
                               rtol=0, atol=0)
    # more residue rows than 8 members of 16 rows each: refused unread
    assert host_lib.ntt_decrypt_tail(
        x.data_ptr(), c0.data_ptr(), out.data_ptr(), dt.k2_rows.data_ptr(),
        dt.glob.data_ptr(), J, 129, p.n, *bfv_tail._t_strategy(dt.tmeta),
        None) != 0


@functools.cache
def _rk_params(rk: int, t: int):
    return primegen.make_bfv_params(256, 40, rk + 1, t=t)


@pytest.mark.parametrize("t", [1024, 12289], ids=["pow2_t", "odd_t"])
@pytest.mark.parametrize("rk", [*range(1, 17), 17, 23, 32])
def test_host_decrypt_tail_every_rk(host_lib, rk, t):
    """K2 at rk = 1..16 residue rows and a few beyond, against its plain
    version, J = 2, n = 256: every G of the launchers' rule (2 up to 10
    rows, 4 up to 20, 8 beyond), rk not a multiple of G included."""
    p = _rk_params(rk, t)
    rng = np.random.default_rng(rk + t)
    dt = bfv_tail.DecTailConsts.build(p)
    x = _rand_res(rng, p.q[:-1], p.n, (2,))
    c0 = _rand_res(rng, p.q[:-1], p.n, (2,))
    rc, out = _host_decrypt_tail(host_lib, x, c0, dt)
    assert rc == 0
    torch.testing.assert_close(out, bfv_tail.decrypt_tail_plain(x, c0, dt),
                               rtol=0, atol=0)


# The stage launchers' cases: (J, B), B the cluster size (blocks per
# polynomial, 0 for the launchers' rule).  The rule at J = 1 and 3 with the
# three prologues of kernels 7, 9 and 10 (and 7, 8); at J = 1 also every B
# with every prologue, mod_idx (kernel 12) and a shard offset (logc = 1,
# shards 0 and 1).  A B that a launch cannot take (B = 1 at 2^15) must be
# refused.
STAGE_CASES = [(1, 0), (3, 0), (1, 1), (1, 2), (1, 4), (1, 8)]
STAGE_IDS = ["1", "3", "1-B1", "1-B2", "1-B4", "1-B8"]


def _ptr(t):
    return None if t is None else t.data_ptr()


def _takes(B, n):
    """Whether the stage launchers take cluster size B at n points."""
    return B == 0 or (2 <= n // B <= 16384)


def _host_stage(host_lib, inverse, B, out, tb, pro, P, logn, x=None, d=None,
                y=None, e=None, nu=None, ny=1, mod_idx=None, logc=0,
                shard=0):
    """One host-built stage launch through the rule's entry point (B = 0)
    or the one that takes B; its return code."""
    if inverse:
        args = (_ptr(x), _ptr(y), _ptr(e), out.data_ptr(), *tb.kernel_args(),
                pro, ny, P, tb.r, logn, _ptr(mod_idx), logc, shard)
        fn = "ntt_stage_inverse"
    else:
        args = (_ptr(x), _ptr(d), _ptr(y), _ptr(nu), out.data_ptr(),
                *tb.kernel_args(), pro, P, tb.r, logn, _ptr(mod_idx), logc,
                shard)
        fn = "ntt_stage_forward"
    if B == 0:
        return getattr(host_lib, fn)(*args, None)
    return getattr(host_lib, fn + "_cluster")(*args, B, None)


# plain results by (set, direction, J, case): every B of a case has the
# same seeded inputs, so the plain version runs once per case
_PLAIN = {}


def _check_host_stage(host_lib, key, inverse, B, n, plain, shape, **kw):
    """The launch into a fresh (shape) output equals plain() exactly, or is
    refused where B does not fit n points."""
    out = torch.empty(shape, dtype=torch.int64)
    logn = n.bit_length() - 1
    rc = _host_stage(host_lib, inverse, B, out, pro=kw.pop("pro"),
                     P=out.numel() // n, logn=logn, **kw)
    if not _takes(B, n):
        assert rc != 0
        return
    assert rc == 0
    if key not in _PLAIN:
        _PLAIN[key] = plain()
    torch.testing.assert_close(out, _PLAIN[key], rtol=0, atol=0)


def _mod_idx_case(rng, p):
    """A permuted index over B = 2r + 1 polynomials and their residues."""
    idx = torch.from_numpy(
        rng.permutation(np.arange(2 * p.r + 1) % p.r).astype(np.int32))
    x = torch.from_numpy(np.stack([rng.integers(0, p.q[i], p.n)
                                   for i in idx.tolist()]))
    return idx, x


@pytest.mark.parametrize("J,B", STAGE_CASES, ids=STAGE_IDS)
def test_host_stage_forward(host_lib, stage_ctx, J, B):
    """Kernels 7 (forward), 9 and 10: every forward prologue; at J = 1 also
    11's and 19's, kernel 12's mod_idx and the shard offset."""
    p, tb = stage_ctx.params, stage_ctx.tables_full
    n, r = p.n, p.r
    rng = np.random.default_rng(30 + J)
    x = _rand_res(rng, p.q, n, (J,))
    d = torch.from_numpy(rng.integers(-19, 17, (J, n)).astype(np.int32))
    d[:, :3] = torch.tensor([1, -1, 2])
    x[:, :, 0] = torch.tensor(p.q) - 1   # x + e == q: the 0 fixup
    t = d.clamp(-1, 2)
    key = lambda case: (p.name, "fwd", J, case)
    chk = lambda case, plain, **kw: _check_host_stage(
        host_lib, key(case), False, B, n, plain, x.shape, tb=tb, **kw)
    chk("copy", lambda: ntt_stage.ntt_forward_plain(x, tb),
        pro=cuda.PRO_COPY, x=x)
    chk("ternary", lambda: ntt_stage.ntt_forward_ternary_plain(t, tb),
        pro=cuda.PRO_TERNARY, d=t)
    chk("addneg_gauss",
        lambda: ntt_stage.ntt_forward_addneg_gauss_plain(x, d, tb),
        pro=cuda.PRO_ADDNEG_GAUSS, x=x, d=d)
    if J != 1:
        return
    e = _rand_res(rng, p.q, n, (J,))
    e[:, :, 0] = 1                        # x + e == q
    chk("addneg", lambda: ntt_stage.ntt_forward_addneg_plain(x, e, tb),
        pro=cuda.PRO_ADDNEG, x=x, y=e)
    c2 = torch.from_numpy(rng.integers(0, max(p.q), (2, n)))  # digit rows
    _check_host_stage(
        host_lib, key("digit"), False, B, n,
        lambda: ntt.ntt_forward(modmath.mod_u64(c2[:, None, :], tb.ms.q,
                                                tb.ms.nu), tb),
        (2, r, n), tb=tb, pro=cuda.PRO_DIGIT, x=c2, nu=tb.ms.nu)
    idx, xi = _mod_idx_case(rng, p)
    _check_host_stage(
        host_lib, key("mod_idx"), False, B, n,
        lambda: ntt_stage.ntt_transform_idx_plain(xi, tb, idx), xi.shape,
        tb=tb, pro=cuda.PRO_COPY, x=xi, mod_idx=idx)
    for c in (0, 1):
        xs = _rand_res(rng, p.q, n // 2)
        _check_host_stage(
            host_lib, key(f"shard{c}"), False, B, n // 2,
            lambda: sharded.local_forward_stages(xs, tb, 2, c), xs.shape,
            tb=tb, pro=cuda.PRO_COPY, x=xs, logc=1, shard=c)


@pytest.mark.parametrize("J,B", STAGE_CASES, ids=STAGE_IDS)
def test_host_stage_inverse(host_lib, stage_ctx, J, B):
    """Kernels 7 (inverse) and 8, y shared by the J messages or not; at
    J = 1 also 13's +e epilogue, 19's PRO_KSACC, kernel 12's mod_idx and
    the shard offset, and PRO_KSACC with the shard offset (kernel 20's
    launch in the 2-D key switch) at C = 2 and 4."""
    p, tb = stage_ctx.params, stage_ctx.tables_full
    n, r, ms = p.n, p.r, tb.ms
    rng = np.random.default_rng(40 + J)
    x = _rand_res(rng, p.q, n, (J,))
    key = lambda case: (p.name, "inv", J, case)
    for i, y in enumerate((None, _rand_res(rng, p.q, n),
                           _rand_res(rng, p.q, n, (J,)))):
        _check_host_stage(
            host_lib, key(f"y{i}"), True, B, n,
            (lambda: ntt_stage.ntt_inverse_plain(x, tb)) if y is None else
            (lambda: ntt_stage.ntt_inverse_mul_plain(x, y, tb)), x.shape,
            tb=tb, pro=cuda.PRO_COPY if y is None else cuda.PRO_MONT, x=x,
            y=y, ny=1 if y is None else y.numel() // n)
    if J != 1:
        return
    pk, u = _rand_res(rng, p.q, n, (2,)), _rand_res(rng, p.q, n)
    e2 = torch.from_numpy(rng.integers(-19, 17, (2, n)).astype(np.int32))
    _check_host_stage(
        host_lib, key("mont_e"), True, B, n,
        lambda: poly.poly_add(ntt.ntt_inverse(ntt.dyadic_mul(u[None], pk, ms),
                                              tb),
                              sampling.small_res(e2, ms.q), ms),
        pk.shape, tb=tb, pro=cuda.PRO_MONT, x=pk, y=u, e=e2, ny=r)
    k = 2
    c2 = torch.from_numpy(rng.integers(0, max(p.q), (k, n)))
    ksk = _rand_res(rng, p.q, n, (2, k))
    dhat = ntt.ntt_forward(modmath.mod_u64(c2[:, None, :], ms.q, ms.nu), tb)
    _check_host_stage(
        host_lib, key("ksacc"), True, B, n,
        lambda: fused_ops.keyswitch_front_plain(c2, ksk, tb), (2, r, n),
        tb=tb, pro=cuda.PRO_KSACC, x=dhat, y=ksk, ny=k)
    idx, xi = _mod_idx_case(rng, p)
    _check_host_stage(
        host_lib, key("mod_idx"), True, B, n,
        lambda: ntt_stage.ntt_transform_idx_plain(xi, tb, idx, inverse=True),
        xi.shape, tb=tb, pro=cuda.PRO_COPY, x=xi, mod_idx=idx)
    for c in (0, 1):
        xs, ys = _rand_res(rng, p.q, n // 2), _rand_res(rng, p.q, n // 2)
        _check_host_stage(
            host_lib, key(f"shard{c}"), True, B, n // 2,
            lambda: coef_kernels.local_inverse_mul_plain(xs, ys, tb, 2, c),
            xs.shape, tb=tb, pro=cuda.PRO_MONT, x=xs, y=ys, ny=r, logc=1,
            shard=c)
    for C in (2, 4):       # the 2-D key switch's accumulate on a shard
        logc, S = C.bit_length() - 1, n // C
        dk, kk = _rand_res(rng, p.q, S, (k,)), _rand_res(rng, p.q, S, (2, k))
        for c in range(C):
            _check_host_stage(
                host_lib, key(f"ksacc_shard{C}_{c}"), True, B, S,
                lambda: coef_kernels.local_keyswitch_acc_plain(dk, kk, tb, C,
                                                               c),
                (2, r, S), tb=tb, pro=cuda.PRO_KSACC, x=dk, y=kk, ny=k,
                logc=logc, shard=c)


def test_host_stage_cluster_rule(host_lib):
    """The launchers' rule: the largest cluster size B <= 8 a launch of n
    points takes (a block holds 2 to 2^14 points); none past 2^17."""
    for logn, B in ((17, 8), (16, 8), (15, 8), (14, 8), (12, 8), (4, 8),
                    (3, 4), (2, 2), (1, 1)):
        assert host_lib.ntt_stage_cluster_size(logn) == B, logn
    for logn in (0, 18):
        assert host_lib.ntt_stage_cluster_size(logn) == 0


def test_host_stage_encrypt(host_lib, stage_ctx):
    """Kernel 13: the inverse with Montgomery prologue and +e epilogue into
    a (2, r, n) scratch, then the encrypt tail at J = 1."""
    p, tb, tc = stage_ctx.params, stage_ctx.tables_full, stage_ctx.tail_consts
    rng = np.random.default_rng(50)
    _, pk = stage_ctx.keygen(nonce=2)
    u_ntt = ntt_stage.ntt_forward_ternary(
        torch.from_numpy(rng.integers(-1, 3, p.n).astype(np.int32)), tb)
    e_d = torch.from_numpy(rng.integers(-19, 17, (2, p.n)).astype(np.int32))
    m = torch.from_numpy(rng.integers(0, p.t, p.n))
    scratch = torch.empty((2, p.r, p.n), dtype=torch.int64)
    ct = torch.empty((2, p.r - 1, p.n), dtype=torch.int64)
    assert host_lib.ntt_stage_inverse(
        pk.data_ptr(), u_ntt.data_ptr(), e_d.data_ptr(), scratch.data_ptr(),
        *tb.kernel_args(), cuda.PRO_MONT, p.r, 2 * p.r, p.r, p.logn, None, 0, 0, None) == 0
    assert host_lib.ntt_encrypt_tail(scratch.data_ptr(), m.data_ptr(),
                                     ct.data_ptr(), tc.tail_rows.data_ptr(),
                                     tc.q_last, tc.half, tc.fix_th, 1, p.r,
                                     p.n, None) == 0
    ref = bfv_tail.encrypt_fused_plain(u_ntt, pk, e_d, m, tb, tc)
    torch.testing.assert_close(ct, ref, rtol=0, atol=0)


def test_host_stage_rejects_bad_arguments(host_lib, stage_ctx):
    """The launchers refuse what the kernels do not take (rc != 0)."""
    p, tb = stage_ctx.params, stage_ctx.tables_full
    x = torch.zeros((p.r, p.n), dtype=torch.int64)
    for pro, P, logn in ((cuda.PRO_MONT, p.r, p.logn),   # forward: no y
                         (cuda.PRO_KSACC, p.r, p.logn),  # an inverse prologue
                         (cuda.PRO_COPY, p.r + 1, p.logn),  # P % r
                         (cuda.PRO_COPY, p.r, 18)):       # 2^18
        assert host_lib.ntt_stage_forward(x.data_ptr(), None, None, None,
                                          x.data_ptr(), *tb.kernel_args(), pro,
                                          P, p.r, logn, None, 0, 0, None) != 0
    for pro, P in ((cuda.PRO_TERNARY, p.r), (cuda.PRO_DIGIT, p.r),
                   (cuda.PRO_KSACC, p.r)):               # KSACC: P % 2r
        assert host_lib.ntt_stage_inverse(x.data_ptr(), None, None,
                                          x.data_ptr(), *tb.kernel_args(), pro,
                                          1, P, p.r, p.logn, None, 0, 0, None) != 0


# --- EvalMult: the BEHZ conversions (21a-c), kernel 11 and the key switch
# (19), and the stage transforms over Bsk's 60-bit moduli -----------------

@pytest.fixture(scope="module",
                params=[SMALL, get_bfv_params("4k_3q"),
                        get_bfv_params("32k_9q"), get_bfv_params("32k_16q")],
                ids=lambda p: p.name)
def banks(request):
    return request.param, behz_kernels.MultBanks.build(request.param)


def _xm_at_half(xb_col, aux) -> int:
    """The m_sk residue that puts bsk_to_q's alpha exactly at m_sk >> 1
    (the strict-`>` boundary) for the B residues xb_col of one
    coefficient."""
    b_prod, msk = behz.prod(aux.b), aux.m_sk
    cm = sum((int(x) * pow(b_prod // bj % bj, -1, bj) % bj) * (b_prod // bj)
             for x, bj in zip(xb_col, aux.b))
    return (cm - (msk >> 1) * b_prod) % msk


def _host_behz(host_lib, which, x, xb, out, mb, row0=0, group=0):
    """One conversion into out (..., rl, n): target rows [row0, row0 + rl),
    the whole output at row0 = 0; G = group threads a coefficient (0: the
    launchers' rule)."""
    k, n, rl = mb.k, x.shape[-1], out.shape[-2]
    C = out.numel() // (rl * n)
    return host_lib.ntt_behz(which, x.data_ptr(),
                             None if xb is None else xb.data_ptr(),
                             out.data_ptr(), *mb.kernel_args(), C, k, n, row0,
                             rl, group, None)


def _check_host_behz(host_lib, mb, xq, xb):
    """21a-c and the one-launch scale_and_round at every group size G
    against their plain versions."""
    for which, args, plain in (
            (behz_kernels.RNS_TO_BSK, (xq, None), behz_kernels.rns_to_bsk_plain),
            (behz_kernels.FAST_FLOOR, (xq, xb), behz_kernels.fast_floor_plain),
            (behz_kernels.BSK_TO_Q, (xb, None), behz_kernels.bsk_to_q_plain),
            (behz_kernels.SCALE_AND_ROUND, (xq, xb),
             behz_kernels.scale_and_round_plain)):
        ref = plain(*[a for a in args if a is not None], mb)
        for G in (0,) + behz_kernels.GROUPS:
            out = torch.empty_like(ref)
            assert _host_behz(host_lib, which, *args, out, mb, group=G) == 0
            torch.testing.assert_close(out, ref, rtol=0, atol=0,
                                       msg=f"which {which} G {G}")


def test_host_behz(host_lib, banks):
    """Kernels 21a-c and scale_and_round against ops/behz.py with a (J, C)
    = (2, 3) lead, values at the range ends and alpha at m_sk / 2
    included, at every group size G.  The conversions are per coefficient,
    so the 32k sets' constants are checked over n = 2048."""
    params, mb = banks
    mc = mb.mc
    k, n = mb.k, 2048
    rng = np.random.default_rng(60 + k)
    qs = [int(v) for v in mc.ms_q.q.flatten()]
    bsk = [int(v) for v in mc.ms_bsk.q.flatten()]
    xq = _rand_res(rng, qs, n, (2, 3))
    xb = _rand_res(rng, bsk, n, (2, 3))
    xq[..., :2] = torch.tensor([[0, q - 1] for q in qs])
    xb[..., :2] = torch.tensor([[0, m - 1] for m in bsk])
    aux = behz.AuxBase.build(params)
    xb[0, 0, k, 2] = _xm_at_half(xb[0, 0, :k, 2].tolist(), aux)
    _check_host_behz(host_lib, mb, xq, xb)


@pytest.mark.parametrize("k", range(1, behz_kernels.MAX_K + 1))
def test_host_behz_every_k(host_lib, k):
    """Every K instantiation of the conversion kernels, k = 1..16 (a
    generated r = k + 1 set at n = 256, (2, 2) lead, n not a multiple of
    the block's coefficients at G = 1), at every G."""
    params = primegen.make_bfv_params(256, 36, k + 1)
    mb = behz_kernels.MultBanks.build(params)
    rng = np.random.default_rng(k)
    n = 200
    xq = _rand_res(rng, params.q[:-1], n, (2, 2))
    xb = _rand_res(rng, [int(v) for v in mb.mc.ms_bsk.q.flatten()], n,
                   (2, 2))
    _check_host_behz(host_lib, mb, xq, xb)


def test_host_behz_rejects_bad_arguments(host_lib, banks):
    _, mb = banks
    k = mb.k
    x = torch.zeros((k + 1, 64), dtype=torch.int64)
    assert _host_behz(host_lib, behz_kernels.FAST_FLOOR, x, None, x,
                      mb) != 0                  # fast_floor needs xb
    assert host_lib.ntt_behz(7, x.data_ptr(), None, x.data_ptr(),
                             *mb.kernel_args(), 1, k, 64, 0, k, 0,
                             None) != 0
    for G in (-1, 3, 4):                        # G: 1 or 2 (0: the rule)
        assert _host_behz(host_lib, behz_kernels.RNS_TO_BSK, x[:k], None, x,
                          mb, group=G) != 0
    # scale_and_round: the whole of q, and xb
    for row0, rl, xb in ((0, k + 1, x), (1, k, x), (0, k, None)):
        assert host_lib.ntt_behz(
            behz_kernels.SCALE_AND_ROUND, x.data_ptr(), _ptr(xb),
            x.data_ptr(), *mb.kernel_args(), 1, k, 64, row0, rl, 0,
            None) != 0


@pytest.mark.parametrize("J", [1, 2])
def test_host_forward_addneg(host_lib, stage_ctx, J):
    """Kernel 11: NTT(-(x + e)) with a u64 e, the 0 fixup included."""
    p, tb = stage_ctx.params, stage_ctx.tables_full
    rng = np.random.default_rng(70 + J)
    x = _rand_res(rng, p.q, p.n, (J,))
    e = _rand_res(rng, p.q, p.n, (J,))
    x[:, :, 0] = torch.tensor(p.q) - 1
    e[:, :, 0] = 1                        # x + e == q
    out = torch.empty_like(x)
    assert host_lib.ntt_stage_forward(x.data_ptr(), None, e.data_ptr(), None,
                                      out.data_ptr(), *tb.kernel_args(),
                                      cuda.PRO_ADDNEG, J * p.r, p.r, p.logn,
                                      None, 0, 0, None) == 0
    ref = ntt_stage.ntt_forward_addneg_plain(x, e, tb)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


def _host_keyswitch(host_lib, ctx, J):
    """Kernel 19 through the host build's stage entry points (PRO_DIGIT
    forward, PRO_KSACC inverse) and the tail, against the plain chain."""
    p, tb, tc = ctx.params, ctx.tables_full, ctx.tail_consts
    k, r, n = p.r - 1, p.r, p.n
    rng = np.random.default_rng(80)
    c2 = _rand_res(rng, p.q[:-1], n, (J,))
    ksk = _rand_res(rng, p.q, n, (2, k))
    dhat = torch.empty((J, k, r, n), dtype=torch.int64)
    acc = torch.empty((J, 2, r, n), dtype=torch.int64)
    out = torch.empty((J, 2, k, n), dtype=torch.int64)
    assert host_lib.ntt_stage_forward(c2.data_ptr(), None, None,
                                      tb.ms.nu.data_ptr(), dhat.data_ptr(),
                                      *tb.kernel_args(), cuda.PRO_DIGIT,
                                      J * k * r, r, p.logn, None, 0, 0, None) == 0
    assert host_lib.ntt_stage_inverse(dhat.data_ptr(), ksk.data_ptr(), None,
                                      acc.data_ptr(), *tb.kernel_args(),
                                      cuda.PRO_KSACC, k, J * 2 * r, r, p.logn,
                                      None, 0, 0, None) == 0
    assert host_lib.ntt_encrypt_tail(acc.data_ptr(), None, out.data_ptr(),
                                     tc.tail_rows.data_ptr(), tc.q_last,
                                     tc.half, tc.fix_th, J, r, n, None) == 0
    ref = fused_ops.keyswitch_fused_plain(c2, ksk, tb, tc)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


def test_host_keyswitch(host_lib, stage_ctx):
    """Kernel 19: the PRO_DIGIT forward, the PRO_KSACC inverse and the tail
    without a message (J = 2; J = 1 at 2^15) against the xla chain."""
    _host_keyswitch(host_lib, stage_ctx,
                    1 if stage_ctx.params.n > 16384 else 2)


def test_host_keyswitch_k15(host_lib):
    """Kernel 19 at 32k_16q's sixteen moduli (15 digits; n = 1024, roots
    psi^32), J = 2, equal to the plain chain."""
    p = get_bfv_params("32k_16q")
    small = BFVParams(name="32k_16q_n1024", n=1024, q=p.q,
                      psi=tuple(pow(s, 32, q) for s, q in zip(p.psi, p.q)),
                      t=p.t, gamma=p.gamma)
    _host_keyswitch(host_lib, BFVContext.build(small, device="cpu",
                                               fusion="stage"), 2)


def test_host_stage_bsk_tables(host_lib, stage_ctx):
    """Kernels 7 and 8 over Bsk (60-bit moduli, new to the transforms)."""
    p = stage_ctx.params
    aux = behz.AuxBase.build(p)
    tb = ntt.NTTTables.build(aux.bsk, aux.bsk_psi, p.n, device="cpu")
    rng = np.random.default_rng(90)
    x = _rand_res(rng, aux.bsk, p.n, (2,))
    y = _rand_res(rng, aux.bsk, p.n, (2,))
    x[:, :, 0] = torch.tensor(aux.bsk) - 1
    P = 2 * tb.r
    out = torch.empty_like(x)
    assert host_lib.ntt_stage_forward(x.data_ptr(), None, None, None,
                                      out.data_ptr(), *tb.kernel_args(),
                                      cuda.PRO_COPY, P, tb.r, p.logn,
                                      None, 0, 0, None) == 0
    torch.testing.assert_close(out, ntt_stage.ntt_forward_plain(x, tb),
                               rtol=0, atol=0)
    for yy, plain in ((None, lambda: ntt_stage.ntt_inverse_plain(x, tb)),
                      (y, lambda: ntt_stage.ntt_inverse_mul_plain(x, y, tb))):
        assert host_lib.ntt_stage_inverse(
            x.data_ptr(), None if yy is None else yy.data_ptr(), None,
            out.data_ptr(), *tb.kernel_args(),
            cuda.PRO_COPY if yy is None else cuda.PRO_MONT, P, P, tb.r,
            p.logn, None, 0, 0, None) == 0
        torch.testing.assert_close(out, plain(), rtol=0, atol=0)


# --- kernel 22: the 30-bit family transform (u32, n up to 2^16) -----------

def _tables30(n, two_moduli=False):
    """NTTTables30 of the family's modulus at n, or of two generated 30-bit
    moduli (polynomial p takes modulus p % 2)."""
    if two_moduli:
        qs = primegen.generate_moduli(n, 30, 2)
        psis = [primegen.find_primitive_2n_root(q, n) for q in qs]
    else:
        q, psi, *_ = get_params(n, "30bit")
        qs, psis = [q], [psi]
    return ntt30.NTTTables30.build(qs, psis, n, device="cpu")


def _rand30(rng, tb, polys):
    qs = [int(v) for v in tb.consts[:, 0]]
    return torch.from_numpy(np.stack(
        [rng.integers(0, qs[p % tb.r], tb.n) for p in range(polys)])
        .astype(np.int32))


@pytest.mark.parametrize("B", [1, 2, 4, 8])
@pytest.mark.parametrize("lead", [(2, 1), (4, 2)], ids=["2x1", "4x2"])
@pytest.mark.parametrize("n", [2048, 65536])
def test_host_ntt30(host_lib, n, lead, B):
    """Kernel 22 forward and inverse at cluster size B over (J, r, n)
    (polynomial p takes modulus p % r), out of place and in place; B = 1 at
    2^16, whose 256 KB buffer does not fit a block, refused."""
    tb = _tables30(n, two_moduli=lead[1] == 2)
    rng = np.random.default_rng(110)
    P = lead[0] * lead[1]
    x = _rand30(rng, tb, P)
    x[:, :2] = 0
    for inverse, plain in ((0, ntt30.ntt_forward_plain),
                           (1, ntt30.ntt_inverse_plain)):
        out = torch.zeros_like(x)
        rc = host_lib.ntt30_transform(x.data_ptr(), out.data_ptr(),
                                      *tb.kernel_args(), inverse, P, tb.r,
                                      tb.logn, B, None)
        if n // B > 2 * cuda.BLOCK_MAX_N:
            assert rc != 0 and not out.any()
            continue
        assert rc == 0
        ref = plain(x, tb)
        torch.testing.assert_close(out, ref, rtol=0, atol=0)
        y = x.clone()
        assert host_lib.ntt30_transform(y.data_ptr(), y.data_ptr(),
                                        *tb.kernel_args(), inverse, P, tb.r,
                                        tb.logn, B, None) == 0
        torch.testing.assert_close(y, ref, rtol=0, atol=0)


def test_host_ntt30_rejects_bad_arguments(host_lib):
    """A batch that is not a multiple of r, n outside [2, 2^16] (2^17
    included), no polynomial, and a cluster size the shape cannot take:
    B = 1 at 2^16, B = 16, B = 3."""
    tb = _tables30(2048, two_moduli=True)
    x = torch.zeros((2, 65536), dtype=torch.int32)
    for P, logn, B in ((3, tb.logn, 0), (2, 17, 0), (2, 0, 0),
                       (0, tb.logn, 0), (2, 16, 1), (2, tb.logn, 16),
                       (2, tb.logn, 3), (2, 17, 8)):
        assert host_lib.ntt30_transform(x.data_ptr(), x.data_ptr(),
                                        *tb.kernel_args(), 0, P, tb.r, logn,
                                        B, None) != 0


# --- on the card -----------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["4k_3q", "16k_5q"])
def test_cuda_kernels_match_plain(cuda_device, name):
    p = get_bfv_params(name)
    ctx = BFVContext.build(p, device=cuda_device)
    rng = np.random.default_rng(1)
    for ctr0 in (0, 2**32 - 5):
        assert torch.equal(
            salsa20.keystream_words(777, nonce=9 | (1 << 63), counter0=ctr0,
                                    device=cuda_device),
            salsa20.keystream_words_plain(777, nonce=9 | (1 << 63),
                                          counter0=ctr0, device=cuda_device))
    s_b, a, e_d = sampling.keygen_draws_compact(p.n, p.r, ctx.tables_full.ms,
                                                nonce=1)
    got = fused_ops.keygen_fused(s_b, a, e_d, ctx.tables_full)
    ref = fused_ops.keygen_fused_plain(s_b, a, e_d, ctx.tables_full)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    pk = torch.stack([got[1], a])
    for J in (1, 3):
        x = _rand_res(rng, p.q[:-1], p.n, (J,)).to(cuda_device)
        c0 = _rand_res(rng, p.q[:-1], p.n, (J,)).to(cuda_device)
        assert torch.equal(fused_ops.half_polymul(x, got[0][:-1].contiguous(),
                                                  ctx.tables_drop),
                           fused_ops.half_polymul_plain(x, got[0][:-1],
                                                        ctx.tables_drop))
        dt = ctx.dec_tail_consts
        assert torch.equal(bfv_tail.decrypt_tail(x, c0, dt),
                           bfv_tail.decrypt_tail_plain(x, c0, dt))
        draws = [sampling.encrypt_draws_compact(p.n, nonce=k + 1,
                                                device=cuda_device)
                 for k in range(J)]
        u_b = torch.stack([d[0] for d in draws])
        e_d = torch.stack([d[1] for d in draws])
        m = torch.from_numpy(rng.integers(0, p.t, (J, p.n))).to(cuda_device)
        assert torch.equal(
            fused_ops.encrypt_fused(u_b, pk, e_d, m, ctx.tables_full,
                                    ctx.tail_consts),
            fused_ops.encrypt_fused_plain(u_b, pk, e_d, m, ctx.tables_full,
                                          ctx.tail_consts))
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["4k_3q", "32k_9q"])
def test_cuda_stage_kernels_match_plain(cuda_device, name):
    p = get_bfv_params(name)
    ctx = BFVContext.build(p, device=cuda_device, fusion="stage")
    tb, tc = ctx.tables_full, ctx.tail_consts
    rng = np.random.default_rng(2)
    for J in (1, 3):
        lead = () if J == 1 else (J,)
        x = _rand_res(rng, p.q, p.n, lead).to(cuda_device)
        y = _rand_res(rng, p.q, p.n).to(cuda_device)
        d = torch.from_numpy(rng.integers(-19, 17, lead + (p.n,))
                             .astype(np.int32)).to(cuda_device)
        t = d.clamp(-1, 2)
        for kern, plain, args in (
                (ntt_stage.ntt_forward, ntt_stage.ntt_forward_plain, (x,)),
                (ntt_stage.ntt_inverse, ntt_stage.ntt_inverse_plain, (x,)),
                (ntt_stage.ntt_inverse_mul, ntt_stage.ntt_inverse_mul_plain,
                 (x, y)),
                (ntt_stage.ntt_forward_ternary,
                 ntt_stage.ntt_forward_ternary_plain, (t,)),
                (ntt_stage.ntt_forward_addneg_gauss,
                 ntt_stage.ntt_forward_addneg_gauss_plain, (x, d))):
            assert torch.equal(kern(*args, tb), plain(*args, tb)), kern.__name__
    _, pk = ctx.keygen(nonce=1)
    u_ntt = ntt_stage.ntt_forward_ternary(t[0] if t.dim() == 2 else t, tb)
    e2 = torch.from_numpy(rng.integers(-19, 17, (2, p.n)).astype(np.int32))
    m = torch.from_numpy(rng.integers(0, p.t, p.n)).to(cuda_device)
    e2 = e2.to(cuda_device)
    assert torch.equal(bfv_tail.encrypt_fused(u_ntt, pk, e2, m, tb, tc),
                       bfv_tail.encrypt_fused_plain(u_ntt, pk, e2, m, tb, tc))
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("B", [2, 4, 8])
def test_cuda_stage_cluster_sizes_match_plain(cuda_device, B):
    """At 32k_9q, every stage row through the launchers at cluster size B:
    7 both ways, 8, 9, 10, 11, 12 both ways, 13's transform (+e), 19/20's
    PRO_DIGIT and PRO_KSACC launches and the shard offsets (C = 2, 4),
    PRO_KSACC's (the 2-D key switch's accumulate) among them."""
    p, dev = get_bfv_params("32k_9q"), cuda_device
    tb = ntt.tables_for(p, device=dev)
    ms, n, r, k = tb.ms, p.n, p.r, p.r - 1
    rng = np.random.default_rng(B)
    x, y, e = (_rand_res(rng, p.q, n).to(dev) for _ in range(3))
    d = torch.from_numpy(rng.integers(-19, 17, (2, n)).astype(np.int32))
    d, t = d.to(dev), d[0].clamp(-1, 2).to(dev)
    pk, ksk = (_rand_res(rng, p.q, n, lead).to(dev) for lead in ((2,), (2, k)))
    c2 = torch.from_numpy(rng.integers(0, max(p.q), (k, n))).to(dev)
    idx, xi = _mod_idx_case(rng, p)
    xi, idx_d = xi.to(dev), idx.to(dev)
    fl = lambda *a, **kw: ntt_stage.forward_launch(dev, *a, cluster=B, **kw)
    il = lambda *a, **kw: ntt_stage.inverse_launch(dev, *a, cluster=B, **kw)

    def run(launch, ref):
        out = torch.empty_like(ref)
        launch(out)
        assert torch.equal(out, ref)

    run(lambda o: fl(x, None, o, tb, cuda.PRO_COPY),
        ntt_stage.ntt_forward_plain(x, tb))
    run(lambda o: il(x, None, None, o, tb), ntt_stage.ntt_inverse_plain(x, tb))
    run(lambda o: il(x, y, None, o, tb),
        ntt_stage.ntt_inverse_mul_plain(x, y, tb))
    run(lambda o: fl(None, t, o, tb, cuda.PRO_TERNARY),
        ntt_stage.ntt_forward_ternary_plain(t, tb))
    run(lambda o: fl(x, d[1].contiguous(), o, tb, cuda.PRO_ADDNEG_GAUSS),
        ntt_stage.ntt_forward_addneg_gauss_plain(x, d[1], tb))
    run(lambda o: fl(x, None, o, tb, cuda.PRO_ADDNEG, y=e),
        ntt_stage.ntt_forward_addneg_plain(x, e, tb))
    run(lambda o: fl(xi, None, o, tb, cuda.PRO_COPY, mod_idx=idx_d),
        ntt_stage.ntt_transform_idx_plain(xi, tb, idx))
    run(lambda o: il(xi, None, None, o, tb, mod_idx=idx_d),
        ntt_stage.ntt_transform_idx_plain(xi, tb, idx, inverse=True))
    run(lambda o: il(pk, y, d, o, tb),
        poly.poly_add(ntt.ntt_inverse(ntt.dyadic_mul(y[None], pk, ms), tb),
                      sampling.small_res(d, ms.q), ms))
    dhat = torch.empty((k, r, n), dtype=torch.int64, device=dev)
    fl(c2, None, dhat, tb, cuda.PRO_DIGIT, nu=ms.nu)
    run(lambda o: cuda.launch(
        "ntt_stage_inverse_cluster", dev, dhat.data_ptr(), ksk.data_ptr(),
        None, o.data_ptr(), *tb.kernel_args(), cuda.PRO_KSACC, k, 2 * r, r,
        p.logn, None, 0, 0, B), fused_ops.keyswitch_front_plain(c2, ksk, tb))
    for C in (2, 4):
        S, logc = n // C, C.bit_length() - 1
        for c in range(C):
            xs = x[:, c * S:(c + 1) * S].contiguous()
            ys = y[:, c * S:(c + 1) * S].contiguous()
            run(lambda o: fl(xs, None, o, tb, cuda.PRO_COPY, logc=logc,
                             shard=c),
                sharded.local_forward_stages(xs, tb, C, c))
            run(lambda o: il(xs, ys, None, o, tb, logc=logc, shard=c),
                coef_kernels.local_inverse_mul_plain(xs, ys, tb, C, c))
            ds = dhat[..., c * S:(c + 1) * S].contiguous()
            ks = ksk[..., c * S:(c + 1) * S].contiguous()
            run(lambda o: cuda.launch(
                "ntt_stage_inverse_cluster", dev, ds.data_ptr(),
                ks.data_ptr(), None, o.data_ptr(), *tb.kernel_args(),
                cuda.PRO_KSACC, k, 2 * r, r, S.bit_length() - 1, None, logc,
                c, B), coef_kernels.local_keyswitch_acc_plain(ds, ks, tb, C,
                                                              c))
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["16k_5q", "32k_9q"])
def test_cuda_encrypt_cluster_sizes_match_plain(cuda_device, name):
    """K5 (J = 1 and 3: its transform's scratch and the wrapper's
    ciphertexts) and kernel 18 on the card at every cluster size B against
    their plain versions; a B whose two n/B buffers do not fit a block
    (B = 1 at 2^14, B = 1 and 2 at 2^15) raises."""
    p, dev = get_bfv_params(name), cuda_device
    ctx = BFVContext.build(p, device=dev, fusion="op")
    tf, tc = ctx.tables_full, ctx.tail_consts
    rng = np.random.default_rng(10)
    for J in (1, 3):
        pk, u_b, e_d, m = _enc_inputs(ctx, rng, J)
        ref = fused_ops.encrypt_fused_plain(u_b, pk, e_d, m, tf, tc)
        ref_c = fused_ops.encrypt_front_plain(u_b[0], pk, tf)
        ref_s = fused_ops.encrypt_transform_plain(u_b, pk, e_d, tf)
        scratch = torch.empty_like(ref_s)
        for B in (1, 2, 4, 8):
            if not _enc_takes(B, p.n):
                with pytest.raises(RuntimeError):
                    fused_ops.encrypt_fused(u_b, pk, e_d, m, tf, tc,
                                            cluster=B)
                with pytest.raises(RuntimeError):
                    fused_ops.encrypt_front(u_b[0], pk, tf, cluster=B)
                continue
            cuda.launch("ntt_encrypt_transform_cluster", dev, u_b.data_ptr(),
                        pk.data_ptr(), e_d.data_ptr(), scratch.data_ptr(),
                        *tf.kernel_args(), J, p.r, p.logn, B)
            assert torch.equal(scratch, ref_s), B
            assert torch.equal(fused_ops.encrypt_fused(
                u_b, pk, e_d, m, tf, tc, cluster=B), ref), B
            assert torch.equal(fused_ops.encrypt_front(
                u_b[0].contiguous(), pk, tf, cluster=B), ref_c), B
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("name", OP_SETS)
def test_cuda_op_cluster_sizes_match_plain(cuda_device, name):
    """K3 (J = 1 and 3) and K4 on the card at every cluster size B against
    their plain versions; a B whose n/B buffer does not fit a block (B = 1
    at 2^15) raises."""
    p, dev = get_bfv_params(name), cuda_device
    td = ntt.tables_for(p, p.r - 1, device=dev)
    tf = ntt.tables_for(p, device=dev)
    rng = np.random.default_rng(11)
    s_b, a, e_d = sampling.keygen_draws_compact(p.n, p.r, tf.ms, nonce=3)
    y = _rand_res(rng, p.q[:-1], p.n).to(dev)
    cases = [(lambda B: fused_ops.keygen_fused(s_b, a, e_d, tf, cluster=B),
              fused_ops.keygen_fused_plain(s_b, a, e_d, tf))]
    for J in (1, 3):
        x = _rand_res(rng, p.q[:-1], p.n, (J,)).to(dev)
        cases.append((lambda B, x=x: (fused_ops.half_polymul(x, y, td,
                                                             cluster=B),),
                      (fused_ops.half_polymul_plain(x, y, td),)))
    for B in OP_BS:
        for call, ref in cases:
            if not _takes(B, p.n):
                with pytest.raises(RuntimeError):
                    call(B)
                continue
            assert all(torch.equal(g, r) for g, r in zip(call(B), ref)), B
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["4k_3q", "32k_9q", "32k_16q"])
def test_cuda_mult_kernels_match_plain(cuda_device, name):
    """Kernels 21a-c and scale_and_round (G = 2 at 4k_3q and 1 at the 32k
    sets, by the launchers' rule), 11 and 19 and the transforms over Bsk
    on the card."""
    p = get_bfv_params(name)
    ctx = BFVContext.build(p, device=cuda_device)
    st = ctx._mult_setup()
    mb, tf, tbsk = st.banks, ctx.tables_full, st.tables_bsk
    k = p.r - 1
    rng = np.random.default_rng(3)
    for J in (1, 2):
        xq = _rand_res(rng, p.q[:-1], p.n, (J, 2)).to(cuda_device)
        xb = _rand_res(rng, st.aux.bsk, p.n, (J, 2)).to(cuda_device)
        for kern, plain, args in (
                (behz_kernels.rns_to_bsk, behz_kernels.rns_to_bsk_plain, (xq,)),
                (behz_kernels.fast_floor, behz_kernels.fast_floor_plain,
                 (xq, xb)),
                (behz_kernels.bsk_to_q, behz_kernels.bsk_to_q_plain, (xb,)),
                (behz_kernels.scale_and_round,
                 behz_kernels.scale_and_round_plain, (xq, xb))):
            assert torch.equal(kern(*args, mb), plain(*args, mb)), \
                kern.__name__
        c2 = _rand_res(rng, p.q[:-1], p.n, (J,)).to(cuda_device)
        ksk = _rand_res(rng, p.q, p.n, (2, k)).to(cuda_device)
        assert torch.equal(
            fused_ops.keyswitch_fused(c2, ksk, tf, ctx.tail_consts),
            fused_ops.keyswitch_fused_plain(c2, ksk, tf, ctx.tail_consts))
        xb0 = xb[:, 0].contiguous()
        for kern, plain, args in (
                (ntt_stage.ntt_forward, ntt_stage.ntt_forward_plain, (xb0,)),
                (ntt_stage.ntt_inverse_mul, ntt_stage.ntt_inverse_mul_plain,
                 (xb0, xb0))):
            assert torch.equal(kern(*args, tbsk), plain(*args, tbsk))
    x = _rand_res(rng, p.q, p.n, (k,)).to(cuda_device)
    e = _rand_res(rng, p.q, p.n, (k,)).to(cuda_device)
    assert torch.equal(ntt_stage.ntt_forward_addneg(x, e, tf),
                       ntt_stage.ntt_forward_addneg_plain(x, e, tf))
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["32k_9q", "32k_16q"])
def test_cuda_op32_kernels_match_plain(cuda_device, name):
    """Kernel 6 and K3-K5 at n = 2^15 on the card, J = 1 and 3."""
    p = get_bfv_params(name)
    ctx = BFVContext.build(p, device=cuda_device, fusion="op")
    tf, td, tc = ctx.tables_full, ctx.tables_drop, ctx.tail_consts
    rng = np.random.default_rng(4)
    nb = (sampling.encrypt_entropy_bytes(p.n) + 63) // 64
    nonces = [0, 1, 2**62 + 5, 7 | (1 << 63)]
    assert torch.equal(
        salsa20.keystream_words_batch(nb, nonces, device=cuda_device),
        salsa20.keystream_words_batch_plain(nb, nonces, device=cuda_device))
    s_b, a, e_d = sampling.keygen_draws_compact(p.n, p.r, tf.ms, nonce=1)
    got = fused_ops.keygen_fused(s_b, a, e_d, tf)
    ref = fused_ops.keygen_fused_plain(s_b, a, e_d, tf)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    for J in (1, 3):
        x = _rand_res(rng, p.q[:-1], p.n, (J,)).to(cuda_device)
        y = _rand_res(rng, p.q[:-1], p.n).to(cuda_device)
        assert torch.equal(fused_ops.half_polymul(x, y, td),
                           fused_ops.half_polymul_plain(x, y, td))
        pk, u_b, e2, m = _enc_inputs(ctx, rng, J)
        assert torch.equal(fused_ops.encrypt_fused(u_b, pk, e2, m, tf, tc),
                           fused_ops.encrypt_fused_plain(u_b, pk, e2, m, tf,
                                                         tc))
    torch.cuda.synchronize()


def _draws_ref(n: int, nonces, device):
    """Kernel 6's stream of the mapped nonces on `device`, then the plain
    converters there."""
    ks = salsa20.keystream_words_batch(
        sampling.encrypt_entropy_bytes(n) // 64,
        sampling.encrypt_nonces(nonces), device=device)
    return (sampling.ternary_int(salsa20.bytes_u8(ks, 0, n)),
            sampling.gaussian_int(salsa20.bytes_u32(ks, n, 2 * n).reshape(
                -1, 2, n)))


@pytest.mark.gpu
@pytest.mark.parametrize("name,J", [("16k_5q", 32), ("32k_9q", 16),
                                    ("16k_5q", 1), ("32k_9q", 1)])
def test_cuda_salsa20_draws_match_kernel6_and_converters(cuda_device, name,
                                                         J):
    """k_salsa20_draws on the card, bit for bit kernel 6's stream followed
    by the plain ternary_int / gaussian_int there, at the client shapes
    (16k_5q J = 32, 32k_9q J = 16) and J = 1: nonce 0 and a nonce with
    bits 32-62 set among the rows (J = 1: each alone); the encryption
    draws take it in one launch; a device-tensor nonce replayed under a
    CUDA graph at two values."""
    from ntt_cuda_tpu_torch.utils import profiling, tracing
    n = get_bfv_params(name).n
    edge = [0, 0x7FFFFFFF00000000 | 5]
    sets = ([edge + list(range(1, J - 1))] if J > 1 else
            [[x] for x in edge])
    for nonces in sets:
        got = salsa20.encrypt_draws_batch(n, nonces, device=cuda_device)
        want = _draws_ref(n, nonces, cuda_device)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        tracing.reset()
        draws = sampling.encrypt_draws_compact_batch(n, nonces,
                                                     device=cuda_device)
        assert tracing.counts()["salsa20.encrypt_draws_batch"] == 1
        assert sum(tracing.counts().values()) == 1
        assert torch.equal(draws[0], want[0]) and torch.equal(draws[1],
                                                              want[1])
    v = salsa20.nonce_tensor(sets[0], cuda_device)
    g = profiling.graphed(lambda v: salsa20.encrypt_draws_batch(n, v), v)
    for k in (3, 2**40 + 11):
        nonces = [x + k for x in sets[0]]
        v.copy_(salsa20.nonce_tensor(nonces, cuda_device))
        u_b, e_d = g()
        want = _draws_ref(n, nonces, cuda_device)
        assert torch.equal(u_b, want[0]) and torch.equal(e_d, want[1])
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("n", [2048, 16384, 32768, 65536])
def test_cuda_ntt30_matches_plain(cuda_device, n):
    """Kernel 22 on the card, (1, 1, n) and bench.py's (16, 1, n), int32
    and int64, forward and inverse, and equal to the 64-bit transform; at
    every cluster size B, B = 1 at 2^16 (a 256 KB buffer) raising."""
    q, psi, *_ = get_params(n, "30bit")
    tb = ntt30.NTTTables30.build([q], [psi], n, cuda_device)
    tb64 = ntt.NTTTables.build([q], [psi], n, cuda_device)
    rng = np.random.default_rng(5)
    for lead in ((1, 1), (16, 1)):
        x = torch.from_numpy(rng.integers(0, q, lead + (n,))).to(cuda_device)
        for dtype in (torch.int32, torch.int64):
            xd = x.to(dtype)
            f = ntt30.ntt_forward(xd, tb)
            assert f.dtype == dtype
            assert torch.equal(f, ntt30.ntt_forward_plain(xd, tb))
            assert torch.equal(f.to(torch.int64), ntt.ntt_forward(x, tb64))
            i = ntt30.ntt_inverse(f, tb)
            assert torch.equal(i, ntt30.ntt_inverse_plain(f, tb))
            assert torch.equal(i, xd)
            for B in OP_BS:
                if n // B > 2 * cuda.BLOCK_MAX_N:
                    with pytest.raises(RuntimeError):
                        ntt30.ntt_forward(xd, tb, cluster=B)
                    continue
                assert torch.equal(ntt30.ntt_forward(xd, tb, cluster=B), f)
                assert torch.equal(ntt30.ntt_inverse(f, tb, cluster=B), i)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["4k_3q", "32k_9q"])
def test_cuda_entry_kernels_match_plain(cuda_device, name):
    """Kernels 12 (a permuted mod_idx, B = 2r + 1, both directions), 14
    (16-byte aligned and not), K5's tail at J = 16, 13 and 15 (one
    cooperative launch, at every cluster size B; B = 1 at 2^15
    raises)."""
    p = get_bfv_params(name)
    rng = np.random.default_rng(12)
    tb = ntt.tables_for(p, device=cuda_device)
    idx = torch.from_numpy(
        rng.permutation(np.arange(2 * p.r + 1) % p.r).astype(np.int32))
    x = torch.from_numpy(np.stack([rng.integers(0, p.q[i], p.n)
                                   for i in idx.tolist()])).to(cuda_device)
    for inverse in (False, True):
        assert torch.equal(
            ntt_stage.ntt_transform_idx(x, tb, idx, inverse=inverse),
            ntt_stage.ntt_transform_idx_plain(x, tb, idx, inverse=inverse))
    tc = bfv_tail.TailConsts.build(p, cuda_device)
    c, e = (_rand_res(rng, p.q, p.n, (2,)).to(cuda_device) for _ in range(2))
    m = torch.from_numpy(rng.integers(0, p.t, p.n)).to(cuda_device)
    want = bfv_tail.encrypt_tail_plain(c, e, m, tc)
    assert torch.equal(bfv_tail.encrypt_tail(c, e, m, tc), want)
    # 8 bytes past a 16-byte boundary: one coefficient a thread (V = 1)
    buf = torch.empty(c.numel() + 1, dtype=c.dtype, device=cuda_device)
    c1 = buf[1:].view(c.shape).copy_(c)
    assert torch.equal(bfv_tail.encrypt_tail(c1, e, m, tc), want)
    # K5's tail at J = 16 (encrypt_batch's shape) and 13's (the stage
    # schedule's encrypt: kernel 8's inverse, then the tail)
    ctx = BFVContext.build(p, device=cuda_device, fusion="op")
    pk, u_b, e2, m2 = _enc_inputs(ctx, rng, 16)
    tf = ctx.tables_full
    assert torch.equal(fused_ops.encrypt_fused(u_b, pk, e2, m2, tf, tc),
                       fused_ops.encrypt_fused_plain(u_b, pk, e2, m2, tf, tc))
    u_ntt = ntt.ntt_forward(sampling.small_res(u_b[0], tf.ms.q), tf)
    assert torch.equal(
        bfv_tail.encrypt_fused(u_ntt, pk, e2[0], m2[0], tf, tc),
        bfv_tail.encrypt_fused_plain(u_ntt, pk, e2[0], m2[0], tf, tc))
    td = ntt.tables_for(p, p.r - 1, device=cuda_device)
    dt = bfv_tail.DecTailConsts.build(p, cuda_device)
    xs, sk, c0 = (_rand_res(rng, p.q[:-1], p.n).to(cuda_device)
                  for _ in range(3))
    ref = bfv_tail.decrypt_fused_plain(xs, sk, c0, td, dt)
    assert torch.equal(bfv_tail.decrypt_fused(xs, sk, c0, td, dt), ref)
    for B in OP_BS:
        if not _takes(B, p.n):
            with pytest.raises(RuntimeError):
                bfv_tail.decrypt_fused(xs, sk, c0, td, dt, cluster=B)
            continue
        assert torch.equal(
            bfv_tail.decrypt_fused(xs, sk, c0, td, dt, cluster=B), ref), B
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("C", [2, 4])
def test_cuda_shard_offset_matches_plain(cuda_device, C):
    """The coefficient-sharded transform at 32k_9q: every shard's cross
    stages (the glue launch) and local launch (kernels 7 and 8 with the
    shard offset) against their plain versions on the same inputs, and
    the assembled result against the plain whole transform and kernels 7
    and 8 on the whole."""
    p = get_bfv_params("32k_9q")
    tb = ntt.tables_for(p, device=cuda_device)
    rng = np.random.default_rng(C)
    x, y = (_rand_res(rng, p.q, p.n).to(cuda_device) for _ in range(2))
    S, logc = p.n // C, sharded.log2_shards(C)
    split = lambda v: [v[:, c * S:(c + 1) * S].contiguous() for c in range(C)]
    xs = split(x)
    for s in range(logc):
        k = sharded.cross_stride(C, s)
        nxt = [coef_kernels.cross_stage(xs[c], xs[c ^ k], tb, C, s, c, False)
               for c in range(C)]
        for c in range(C):
            assert torch.equal(nxt[c], sharded.cross_forward_stage(
                xs[c], xs[c ^ k], tb, C, s, c))
        xs = nxt
    outs = [coef_kernels.local_forward(xs[c], tb, logc, c) for c in range(C)]
    for c in range(C):
        assert torch.equal(outs[c],
                           sharded.local_forward_stages(xs[c], tb, C, c))
    fwd = torch.cat(outs, -1)
    assert torch.equal(fwd, ntt_stage.ntt_forward_plain(x, tb))
    assert torch.equal(fwd, ntt_stage.ntt_forward(x, tb))
    xs, ys = split(x), split(y)
    outs = [coef_kernels.local_inverse_mul(xs[c], ys[c], tb, logc, c)
            for c in range(C)]
    for c in range(C):
        assert torch.equal(outs[c], coef_kernels.local_inverse_mul_plain(
            xs[c], ys[c], tb, C, c))
    xs = outs
    for s in reversed(range(logc)):
        k = sharded.cross_stride(C, s)
        nxt = [coef_kernels.cross_stage(xs[c], xs[c ^ k], tb, C, s, c, True)
               for c in range(C)]
        for c in range(C):
            assert torch.equal(nxt[c], sharded.cross_inverse_stage(
                xs[c], xs[c ^ k], tb, C, s, c, halve=False))
        xs = nxt
    inv = torch.cat(xs, -1)
    assert torch.equal(inv, ntt_stage.ntt_inverse_mul_plain(x, y, tb))
    assert torch.equal(inv, ntt_stage.ntt_inverse_mul(x, y, tb))
    torch.cuda.synchronize()


# --- odd t >= 2^31 and n = 2^16, 2^17 on the card: the twins of
# tests/test_torch_wide_t.py's and tests/test_torch_large_n.py's host-build
# checks --------------------------------------------------------------------

def _wide_t_params(t_bits: int | None = None):
    """Nine 57-bit moduli at n = 32768 (the narrowest width with nine
    primes === 1 mod 2nt) for t = find_plain_modulus(32768, 33), or, with
    t_bits = 62, the same moduli with the largest batching prime below
    2^62."""
    t = primegen.find_plain_modulus(32768, 33)
    p = primegen.make_bfv_params(32768, 57, 9, t=t)
    if t_bits == 62:
        step = 2 * p.n
        t = (bfv_tail.T_MAX - 1) // step * step + 1
        while not primegen.is_prime(t):
            t -= step
        p = BFVParams(name="gen_32768_57b_9q_t62", n=p.n, q=p.q, psi=p.psi,
                      t=t)
    return p


@pytest.mark.gpu
@pytest.mark.parametrize("t_bits", [33, 62])
def test_cuda_decrypt_kernels_wide_t(cuda_device, t_bits):
    """K2 (J = 1, 3), kernel 15 (every B that fits) and kernel 17 (rows
    0-3, 6-9 and 0-9) at an odd t >= 2^31, the wide mod-t strategy, against
    their plain versions on the card."""
    p, dev = _wide_t_params(t_bits), cuda_device
    assert bfv_tail._t_mode(p.t) == 2
    rng = np.random.default_rng(t_bits)
    dt = bfv_tail.DecTailConsts.build(p, dev)
    td = ntt.tables_for(p, p.r - 1, device=dev)
    for J in (1, 3):
        lead = () if J == 1 else (J,)
        x, c0 = (_rand_res(rng, p.q[:-1], p.n, lead).to(dev)
                 for _ in range(2))
        assert torch.equal(bfv_tail.decrypt_tail(x, c0, dt),
                           bfv_tail.decrypt_tail_plain(x, c0, dt))
    x, sk, c0 = (_rand_res(rng, p.q[:-1], p.n).to(dev) for _ in range(3))
    want = bfv_tail.decrypt_fused_plain(x, sk, c0, td, dt)
    for B in (2, 4, 8):
        assert torch.equal(bfv_tail.decrypt_fused(x, sk, c0, td, dt,
                                                  cluster=B), want)
    xf, cf = (_rand_res(rng, p.q, p.n).to(dev) for _ in range(2))
    for lo, hi in ((0, 3), (6, 9), (0, 9)):
        dc = bfv_tail.build_dec_tail_consts_padded(p, lo, hi, device=dev)
        xs, cs = xf[lo:hi].contiguous(), cf[lo:hi].contiguous()
        got = bfv_tail.decrypt_tail_partial(xs, cs, dc)
        want = bfv_tail.decrypt_tail_partial_plain(xs, cs, dc)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.gpu
@pytest.mark.parametrize("logn,r", [(16, 3), (17, 4)])
def test_cuda_large_n_kernels_match_plain(cuda_device, logn, r):
    """At n = 2^16 and 2^17: kernels 7 (both ways), 8, 9 and 10 by the rule,
    K2 and 15; K3, K4 (one buffer a block, B = 8) and K5 and 18 (two
    buffers: B = 8 at 2^16, 16 at 2^17) against their plain versions."""
    p, dev = primegen.make_bfv_params(1 << logn, 55, r), cuda_device
    ctx = BFVContext.build(p, device=dev, fusion="op")
    tf, td, tc, dt = (ctx.tables_full, ctx.tables_drop, ctx.tail_consts,
                      ctx.dec_tail_consts)
    rng = np.random.default_rng(logn)
    x = _rand_res(rng, p.q[:-1], p.n).to(dev)
    y = _rand_res(rng, p.q[:-1], p.n).to(dev)
    d = torch.from_numpy(rng.integers(-19, 17, p.n).astype(np.int32)).to(dev)
    xf = _rand_res(rng, p.q, p.n).to(dev)
    for kern, plain, args in (
            (ntt_stage.ntt_forward, ntt_stage.ntt_forward_plain, (x, td)),
            (ntt_stage.ntt_inverse, ntt_stage.ntt_inverse_plain, (x, td)),
            (ntt_stage.ntt_inverse_mul, ntt_stage.ntt_inverse_mul_plain,
             (x, y, td)),
            (ntt_stage.ntt_forward_ternary,
             ntt_stage.ntt_forward_ternary_plain, (d.clamp(-1, 2), tf)),
            (ntt_stage.ntt_forward_addneg_gauss,
             ntt_stage.ntt_forward_addneg_gauss_plain, (xf, d, tf)),
            (bfv_tail.decrypt_tail, bfv_tail.decrypt_tail_plain, (x, y, dt)),
            (bfv_tail.decrypt_fused, bfv_tail.decrypt_fused_plain,
             (x, y, x, td, dt)),
            (fused_ops.half_polymul, fused_ops.half_polymul_plain,
             (x, y, td)),
            (fused_ops.keygen_fused, fused_ops.keygen_fused_plain,
             (d.clamp(-1, 2), xf, d, tf))):
        for g, w in zip(as_tuple(kern(*args)), as_tuple(plain(*args))):
            assert torch.equal(g, w), kern.__name__
    pk = _rand_res(rng, p.q, p.n, (2,)).to(dev)
    u_b, e_d = sampling.encrypt_draws_compact_batch(p.n, range(1, 3),
                                                    device=dev)
    m = torch.from_numpy(rng.integers(0, p.t, (2, p.n))).to(dev)
    for B in (0, 8 if logn == 16 else 16):
        assert torch.equal(
            fused_ops.encrypt_fused(u_b, pk, e_d, m, tf, tc, cluster=B),
            fused_ops.encrypt_fused_plain(u_b, pk, e_d, m, tf, tc))
        assert torch.equal(fused_ops.encrypt_front(u_b[0], pk, tf, cluster=B),
                           fused_ops.encrypt_front_plain(u_b[0], pk, tf))
    if logn == 17:
        with pytest.raises(RuntimeError):
            fused_ops.encrypt_front(u_b[0], pk, tf, cluster=8)


def as_tuple(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


@pytest.mark.gpu
def test_cuda_fp64_keygen_matches_cpu(cuda_device):
    """uniform_spec="fp64" keygen on the card at 16k_5q (op) and 32k_9q
    (stage) equal to the CPU's plain path, and its program replayed as a
    CUDA graph equal to eager."""
    from ntt_cuda_tpu_torch.utils import profiling
    for name in ("16k_5q", "32k_9q"):
        p = get_bfv_params(name)
        ctx = BFVContext.build(p, device=cuda_device, uniform_spec="fp64")
        got = ctx.keygen(5)
        want = BFVContext.build(p, device="cpu", uniform_spec="fp64").keygen(5)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
        kg_fn, *_, bz = ctx.op_programs()
        g = profiling.graphed(kg_fn, torch.tensor(5, device=cuda_device), bz)
        assert all(torch.equal(a, b) for a, b in zip(g(), got))
