"""BFV at n = 2^16 and 2^17 in the port (the cluster transforms past the
old 2^15 cap) against the JAX package and the plain versions, on the CPU,
exactly.

* The port's plain transforms at 2^16 against the JAX package's
  ops/ntt.py (xla), one 55-bit modulus (`make_bfv_params(65536, 55, 1)`).
* The host build of csrc/ (`cuda.host_library`): the stage kernels (7,
  8: every B that fits and the rule) at 2^16 and 2^17, and the whole-op
  transforms at 2^17 (K3, K4 one buffer a block at B = 8; K5's transform
  and kernel 18, two buffers a block, at B = 16, the rule there, with B
  = 8 refused), each against its plain version on one or two polynomials.
* The cluster rule at 2^16 and 2^17 and the launchers' bounds.
* Marked `slow`: BFV round trips at 2^16 and 2^17 against the JAX
  package's xla context (JAX's own round trip there takes seconds).
"""

import functools

import numpy as np
import pytest
import torch

from ntt_cuda_tpu.ops import modmath as jmm
from ntt_cuda_tpu.ops import ntt as jntt
from ntt_cuda_tpu_torch import BFVContext, convert, cuda
from ntt_cuda_tpu_torch.ops import fused_ops, ntt, ntt_stage
from ntt_cuda_tpu_torch.utils import primegen


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in
    several worker processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.cache
def _params(logn: int, r: int):
    return primegen.make_bfv_params(1 << logn, 55, r)


def _rand_res(rng, qs, n, lead=()):
    return torch.from_numpy(np.stack(
        [rng.integers(0, q, lead + (n,), dtype=np.int64) for q in qs],
        axis=-2))


def test_plain_transforms_2e16_match_jax():
    p = _params(16, 1)
    q = p.q[0]
    x = np.random.default_rng(16).integers(0, q, (1, p.n), dtype=np.uint64)
    jt, jms = jntt.NTTTables.build([q], [p.psi[0]], p.n), \
        jmm.ModulusSet.from_moduli([q])
    tb = ntt.NTTTables.build([q], [p.psi[0]], p.n, device="cpu")
    xt = torch.from_numpy(x.view(np.int64))
    fwd = ntt.ntt_forward(xt, tb)
    np.testing.assert_array_equal(
        convert.to_numpy(fwd), np.asarray(jntt.ntt_forward_jit(x, jt, jms)))
    inv = ntt.ntt_inverse(fwd, tb)
    assert torch.equal(inv, xt)


# --- the cluster kernels on the host build ---------------------------------



@pytest.fixture(scope="module")
def host_lib():
    """csrc/*.cu built as host C++, once per checkout (cuda.host_library)."""
    try:
        return cuda.host_library()
    except cuda.NoHostCompiler as e:
        pytest.skip(str(e))


def test_cluster_rule_and_bounds(host_lib):
    assert cuda.TRANSFORM_MAX_N == 1 << 17
    for logn in (15, 16, 17):
        assert host_lib.ntt_stage_cluster_size(logn) == 8
    assert host_lib.ntt_stage_cluster_size(18) == 0
    tf = [None] * 5
    # two buffers a block: B = 8 at 2^17 passes 128 KB, 16 not at 2^16
    for logn, B in ((17, 8), (17, 4), (16, 16), (18, 0), (18, 16)):
        assert host_lib.ntt_encrypt_front_cluster(
            None, None, None, *tf, 1, logn, B, None) != 0, (logn, B)
    # one buffer a block never takes 16
    assert host_lib.ntt_half_polymul_cluster(
        None, None, None, *tf, 1, 1, 17, 16, None) != 0
    x = torch.zeros((1, 1 << 17), dtype=torch.int64)
    assert host_lib.ntt_stage_forward_cluster(
        x.data_ptr(), None, None, None, x.data_ptr(), *tf, cuda.PRO_COPY, 1,
        1, 17, None, 0, 0, 16, None) != 0


@pytest.mark.parametrize("logn,B", [(16, 0), (16, 4), (17, 0), (17, 8)],
                         ids=["2e16-rule", "2e16-B4", "2e17-rule", "2e17-B8"])
def test_host_stage_large_n(host_lib, logn, B):
    """Kernel 7's forward and kernel 8's INTT(x (.) y) on two polynomials
    (two moduli) against the plain transforms."""
    p = _params(logn, 2)
    tb = ntt.tables_for(p, device="cpu")
    rng = np.random.default_rng(logn + B)
    x = _rand_res(rng, p.q, p.n)
    y = _rand_res(rng, p.q, p.n)
    out = torch.empty_like(x)
    assert host_lib.ntt_stage_forward_cluster(
        x.data_ptr(), None, None, None, out.data_ptr(), *tb.kernel_args(),
        cuda.PRO_COPY, 2, 2, logn, None, 0, 0, B, None) == 0
    assert torch.equal(out, ntt_stage.ntt_forward_plain(x, tb))
    assert host_lib.ntt_stage_inverse_cluster(
        x.data_ptr(), y.data_ptr(), None, out.data_ptr(), *tb.kernel_args(),
        cuda.PRO_MONT, 2, 2, 2, logn, None, 0, 0, B, None) == 0
    assert torch.equal(out, ntt_stage.ntt_inverse_mul_plain(x, y, tb))


def test_host_whole_op_transforms_2e17(host_lib):
    """At 2^17, r = 2: K3 and K4 (one buffer a block, B = 8) and K5's
    transform and kernel 18 (two buffers, B = 16 by the rule and named)."""
    p = _params(17, 2)
    n, logn, r = p.n, 17, 2
    tb = ntt.tables_for(p, device="cpu")
    rng = np.random.default_rng(17)
    x, y, a = (_rand_res(rng, p.q, n) for _ in range(3))
    out = torch.empty_like(x)
    assert host_lib.ntt_half_polymul_cluster(
        x.data_ptr(), y.data_ptr(), out.data_ptr(), *tb.kernel_args(), r, r,
        logn, 0, None) == 0
    assert torch.equal(out, fused_ops.half_polymul_plain(x, y, tb))
    d = torch.from_numpy(rng.integers(-19, 17, (3, n)).astype(np.int32))
    u = torch.from_numpy(rng.integers(-1, 3, (1, n)).astype(np.int32))
    sk, pk0 = torch.empty_like(a), torch.empty_like(a)
    assert host_lib.ntt_keygen_fused_cluster(
        u[0].data_ptr(), a.data_ptr(), d[0].data_ptr(), sk.data_ptr(),
        pk0.data_ptr(), *tb.kernel_args(), r, logn, 8, None) == 0
    want = fused_ops.keygen_fused_plain(u[0], a, d[0], tb)
    assert torch.equal(sk, want[0]) and torch.equal(pk0, want[1])
    pk = torch.stack([x, y])
    e = d[1:].reshape(1, 2, n).contiguous()
    want = fused_ops.encrypt_transform_plain(u, pk, e, tb)
    front = fused_ops.encrypt_front_plain(u[0], pk, tb)
    for B in (0, 16):
        scratch = torch.zeros((1, 2, r, n), dtype=torch.int64)
        assert host_lib.ntt_encrypt_transform_cluster(
            u.data_ptr(), pk.data_ptr(), e.data_ptr(), scratch.data_ptr(),
            *tb.kernel_args(), 1, r, logn, B, None) == 0
        assert torch.equal(scratch, want), B
        c = torch.zeros_like(pk)
        assert host_lib.ntt_encrypt_front_cluster(
            u[0].data_ptr(), pk.data_ptr(), c.data_ptr(), *tb.kernel_args(),
            r, logn, B, None) == 0
        assert torch.equal(c, front), B


# --- BFV round trips against the JAX package (slow) ------------------------

@pytest.mark.slow
@pytest.mark.parametrize("logn,r", [(16, 3), (17, 4)])
def test_bfv_roundtrip_large_n_matches_jax(logn, r):
    from ntt_cuda_tpu.models import bfv as jbfv
    from ntt_cuda_tpu.utils import primegen as jprimegen
    jp = jprimegen.make_bfv_params(1 << logn, 55, r)
    p = _params(logn, r)
    assert p.q == jp.q
    ctx = BFVContext.build(p, device="cpu")
    jctx = jbfv.BFVContext.build(jp, backend="xla")
    sk, pk = ctx.keygen(1)
    m = np.arange(p.n, dtype=np.uint64) % p.t
    ct = ctx.encrypt(pk, m, nonce=2)
    np.testing.assert_array_equal(
        convert.to_numpy(ct),
        np.asarray(jctx.encrypt(convert.to_numpy(pk), m, nonce=2)))
    np.testing.assert_array_equal(convert.to_numpy(ctx.decrypt(sk, ct)), m)
    jsk, _ = jctx.keygen(1)
    np.testing.assert_array_equal(convert.to_numpy(sk), np.asarray(jsk))
