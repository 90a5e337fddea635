"""The port's CUDA kernels (ntt_cuda_tpu_torch/csrc) against their plain
tensor versions, exactly (tolerance 0).

Two ways:

* Here, on the CPU: the same .cu sources compiled by g++ as host code
  (their `#else` branches run each block with one thread, in order, where
  the block barrier is a no-op) and called through the same C launchers.
  This checks each kernel's index algebra and arithmetic without a card.
* On the card (`-m gpu`): each wrapper launches its real kernel on CUDA
  tensors.  These tests skip without a card.  Run them on the card with
  `python -m pytest --noconftest -p no:cacheprovider -m gpu
  tests/test_torch_kernels.py` (the suite's conftest imports jax, which
  a CUDA-only environment need not have).
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from ntt_cuda_tpu_torch import cuda, get_bfv_params
from ntt_cuda_tpu_torch.models.bfv import BFVContext
from ntt_cuda_tpu_torch.ops import bfv_tail, fused_ops, salsa20, sampling
from ntt_cuda_tpu_torch.params import BFVParams

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


def _rand_res(rng, qs, n, lead=()):
    return torch.from_numpy(np.stack(
        [rng.integers(0, q, lead + (n,), dtype=np.int64) for q in qs],
        axis=-2))


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """csrc/*.cu built as host C++ with g++, bound like the CUDA build."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not available to build the kernels as host code")
    out = tmp_path_factory.mktemp("hostkernels") / "libntt_host.so"
    cmd = [gxx, "-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC",
           "-o", str(out), *[str(cuda.CSRC / s) for s in cuda.SOURCES]]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    return cuda.bind(ctypes.CDLL(str(out)))


def _tab(tb):
    return (tb.psi.data_ptr(), tb.psi_shoup.data_ptr(), tb.psiinv.data_ptr(),
            tb.psiinv_shoup.data_ptr(), tb.consts.data_ptr())


@pytest.fixture(scope="module", params=[SMALL, get_bfv_params("4k_3q")],
                ids=lambda p: p.name)
def ctx(request):
    return BFVContext.build(request.param)


@pytest.mark.parametrize("with_u64", [False, True])
def test_host_salsa20(host_lib, with_u64):
    nb = 300
    for nonce, ctr0 in [(0, 0), (7 | (1 << 63), 0), (3, 2**32 - 5)]:
        bw = torch.empty((16, nb), dtype=torch.int64)
        lanes = torch.empty((8, nb), dtype=torch.int64)
        rc = host_lib.ntt_salsa20(bw.data_ptr(),
                                  lanes.data_ptr() if with_u64 else None, nb,
                                  0x01010101, nonce, ctr0, 20, None)
        assert rc == 0
        ref = salsa20.keystream_plain(nb, nonce=nonce, counter0=ctr0,
                                      with_u64=True)
        torch.testing.assert_close(bw, ref[0], rtol=0, atol=0)
        if with_u64:
            torch.testing.assert_close(lanes, ref[1], rtol=0, atol=0)


@pytest.mark.parametrize("J", [1, 3])
def test_host_half_polymul(host_lib, ctx, J):
    p = ctx.params
    rng = np.random.default_rng(J)
    tb = ctx.tables_drop
    x = _rand_res(rng, p.q[:-1], p.n, (J,))
    y = _rand_res(rng, p.q[:-1], p.n)
    out = torch.empty_like(x)
    assert host_lib.ntt_half_polymul(x.data_ptr(), y.data_ptr(),
                                     out.data_ptr(), *_tab(tb), J * tb.r,
                                     tb.r, p.logn, None) == 0
    ref = fused_ops.half_polymul_plain(x, y, tb)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


@pytest.mark.parametrize("nonce", [0, 5])
def test_host_keygen_fused(host_lib, ctx, nonce):
    p = ctx.params
    s_b, a, e_d = sampling.keygen_draws_compact(p.n, p.r, ctx.tables_full.ms,
                                                nonce=nonce)
    sk = torch.empty_like(a)
    pk0 = torch.empty_like(a)
    assert host_lib.ntt_keygen_fused(s_b.data_ptr(), a.data_ptr(),
                                     e_d.data_ptr(), sk.data_ptr(),
                                     pk0.data_ptr(), *_tab(ctx.tables_full),
                                     p.r, p.logn, None) == 0
    sk_ref, pk0_ref = fused_ops.keygen_fused_plain(s_b, a, e_d,
                                                   ctx.tables_full)
    torch.testing.assert_close(sk, sk_ref, rtol=0, atol=0)
    torch.testing.assert_close(pk0, pk0_ref, rtol=0, atol=0)


@pytest.mark.parametrize("J", [1, 3])
def test_host_encrypt_fused(host_lib, ctx, J):
    p = ctx.params
    rng = np.random.default_rng(10 + J)
    _, pk = ctx.keygen(nonce=1)
    draws = [sampling.encrypt_draws_compact(p.n, nonce=k + 1)
             for k in range(J)]
    u_b = torch.stack([d[0] for d in draws])
    e_d = torch.stack([d[1] for d in draws])
    m = torch.from_numpy(rng.integers(0, p.t, (J, p.n), dtype=np.int64))
    m[:, :4] = torch.tensor([0, p.t - 1, p.t // 2, p.t // 2 - 1])
    scratch = torch.empty((J, 2, p.r, p.n), dtype=torch.int64)
    ct = torch.empty((J, 2, p.r - 1, p.n), dtype=torch.int64)
    tc = ctx.tail_consts
    assert host_lib.ntt_encrypt_transform(u_b.data_ptr(), pk.data_ptr(),
                                          e_d.data_ptr(), scratch.data_ptr(),
                                          *_tab(ctx.tables_full), J, p.r,
                                          p.logn, None) == 0
    assert host_lib.ntt_encrypt_tail(scratch.data_ptr(), m.data_ptr(),
                                     ct.data_ptr(), tc.per_mod.data_ptr(),
                                     tc.q_last, tc.half, tc.fix_th, J, p.r,
                                     p.n, None) == 0
    ref = fused_ops.encrypt_fused_plain(u_b, pk, e_d, m, ctx.tables_full, tc)
    torch.testing.assert_close(ct, ref, rtol=0, atol=0)


@pytest.mark.parametrize("params", [SMALL, SMALL_ODD_T], ids=["pow2_t",
                                                              "odd_t"])
@pytest.mark.parametrize("J", [1, 3])
def test_host_decrypt_tail(host_lib, params, J):
    p = params
    rng = np.random.default_rng(20 + J)
    dt = bfv_tail.DecTailConsts.build(p)
    x = _rand_res(rng, p.q[:-1], p.n, (J,))
    c0 = _rand_res(rng, p.q[:-1], p.n, (J,))
    # the strict-`>` boundary: x + c0 == q exactly stays unreduced
    for i, q in enumerate(p.q[:-1]):
        x[:, i, :3] = torch.tensor([q - 1, 0, 5])
        c0[:, i, :3] = torch.tensor([1, 0, q - 5])
    out = torch.empty((J, p.n), dtype=torch.int64)
    assert host_lib.ntt_decrypt_tail(
        x.data_ptr(), c0.data_ptr(), out.data_ptr(), dt.per_mod.data_ptr(),
        dt.glob.data_ptr(), J, p.r - 1, p.n,
        *bfv_tail._t_strategy(dt.tmeta), None) == 0
    ref = bfv_tail.decrypt_tail_plain(x, c0, dt)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


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
    bw, lanes = salsa20.keystream_block_words(777, nonce=9, with_u64=True,
                                              device=cuda_device)
    ref = salsa20.keystream_plain(777, nonce=9, with_u64=True,
                                  device=cuda_device)
    assert torch.equal(bw, ref[0]) and torch.equal(lanes, ref[1])
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
