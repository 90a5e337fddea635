"""The coefficient-sharded NTT of the port (ntt_cuda_tpu_torch/parallel/
sharded.py and coef_kernels.py) in one process, exactly (tolerance 0).

One process drives all C shards stage by stage, handing each cross stage
its partner shard's tensor (what `mesh.ppermute` brings in a sharded
program):

* sharded.py's plain stages (each halving) and coef_kernels' forward,
  inverse and INTT(x (.) y) (the local launches' plain versions and the
  unhalved cross stages) at C = 2, 4 and 8 over 4k_3q, concatenated over
  the shards, against the JAX package's xla transform (ops/ntt.py);
* the host build of csrc/ (tests/test_torch_kernels.py's pattern): the
  stage launchers with a shard offset and the cross-stage glue against
  those plain versions, at C = 2 and 4 over 4k_3q, and at C = 2 over
  n = 65536, whose local 2^15 runs the split schedule (a stage-0 pass at
  psi[C + c] beside two halves at 2 (C + c) + h).
"""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntt_cuda_tpu.ops import modmath as jmm
from ntt_cuda_tpu.ops import ntt as jntt
from ntt_cuda_tpu.params import get_bfv_params as jget
from ntt_cuda_tpu_torch import convert, cuda
from ntt_cuda_tpu_torch.ops import ntt
from ntt_cuda_tpu_torch.parallel import coef_kernels as ck
from ntt_cuda_tpu_torch.parallel import sharded as sh
from ntt_cuda_tpu_torch.utils import primegen


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def host_lib():
    """csrc/*.cu built as host C++, once per checkout (cuda.host_library)."""
    try:
        return cuda.host_library()
    except cuda.NoHostCompiler as e:
        pytest.skip(str(e))


@pytest.fixture(scope="module")
def p4k():
    """4k_3q: the JAX params, the port's tables and seeded (2, r, n)
    inputs x and (r, n) y, with JAX's xla forward, inverse and
    INTT(x (.) y) of them."""
    jp = jget("4k_3q")
    rng = np.random.default_rng(0xC0EF)
    x = np.stack([rng.integers(0, q, (2, jp.n), dtype=np.uint64)
                  for q in jp.q], axis=-2)
    y = np.stack([rng.integers(0, q, jp.n, dtype=np.uint64) for q in jp.q])
    jt, jms = jntt.tables_for(jp), jmm.modulus_set(jp)
    ref = {"fwd": jntt.ntt_forward_jit(jnp.asarray(x), jt, jms),
           "inv": jntt.ntt_inverse_jit(jnp.asarray(x), jt, jms),
           "invmul": jntt.ntt_inverse_jit(
               jntt.dyadic_mul_jit(jnp.asarray(x), jnp.asarray(y), jms), jt,
               jms)}
    return (ntt.tables_for(convert.params_from(jp), device="cpu"),
            convert.to_torch(x, device="cpu"),
            convert.to_torch(y, device="cpu"),
            {k: np.asarray(v) for k, v in ref.items()})


def _split(x, C):
    S = x.shape[-1] // C
    return [x[..., c * S:(c + 1) * S].contiguous() for c in range(C)]


def _cross(xs, C, s, stage):
    """Cross stage s of every shard, each with its partner's tensor."""
    k = sh.cross_stride(C, s)
    return [stage(xs[c], xs[c ^ k], c) for c in range(C)]


def _join(xs):
    return convert.to_numpy(torch.cat(xs, -1))


@pytest.mark.parametrize("C", [2, 4, 8])
def test_sharded_plain_matches_jax(p4k, C):
    """sharded.py: forward_shard's and inverse_shard's stages."""
    tb, x, _, ref = p4k
    xs = _split(x, C)
    for s in range(sh.log2_shards(C)):
        xs = _cross(xs, C, s, lambda a, b, c: sh.cross_forward_stage(
            a, b, tb, C, s, c))
    xs = [sh.local_forward_stages(xs[c], tb, C, c) for c in range(C)]
    np.testing.assert_array_equal(_join(xs), ref["fwd"])
    xs = [sh.local_inverse_stages(v, tb, C, c)
          for c, v in enumerate(_split(x, C))]
    for s in reversed(range(sh.log2_shards(C))):
        xs = _cross(xs, C, s, lambda a, b, c: sh.cross_inverse_stage(
            a, b, tb, C, s, c))
    np.testing.assert_array_equal(_join(xs), ref["inv"])


@pytest.mark.parametrize("C", [2, 4, 8])
def test_coef_kernels_plain_matches_jax(p4k, C):
    """coef_kernels on the CPU: the local launches' plain versions with the
    global n^-1, the cross stages without halving."""
    tb, x, y, ref = p4k
    logc = sh.log2_shards(C)
    xs = _split(x, C)
    for s in range(logc):
        xs = _cross(xs, C, s, lambda a, b, c: ck.cross_stage(
            a, b, tb, C, s, c, inverse=False))
    xs = [ck.local_forward(xs[c], tb, logc, c) for c in range(C)]
    np.testing.assert_array_equal(_join(xs), ref["fwd"])
    for key, ys in (("inv", [None] * C), ("invmul", _split(y, C))):
        xs = [ck.local_inverse_mul(v, ys[c], tb, logc, c)
              for c, v in enumerate(_split(x, C))]
        for s in reversed(range(logc)):
            xs = _cross(xs, C, s, lambda a, b, c: ck.cross_stage(
                a, b, tb, C, s, c, inverse=True))
        np.testing.assert_array_equal(_join(xs), ref[key], err_msg=key)


def _host_local(host_lib, x, y, tb, logc, c, inverse):
    """One shard's local launch of the host build."""
    r, S = tb.r, tb.n >> logc
    out = torch.empty_like(x)
    if inverse:
        rc = host_lib.ntt_stage_inverse(
            x.data_ptr(), None if y is None else y.data_ptr(), None,
            out.data_ptr(), *tb.kernel_args(),
            cuda.PRO_COPY if y is None else cuda.PRO_MONT, 1 if y is None
            else r, x.numel() // S, r, S.bit_length() - 1, None, logc, c,
            None)
    else:
        rc = host_lib.ntt_stage_forward(
            x.data_ptr(), None, None, None, out.data_ptr(), *tb.kernel_args(),
            cuda.PRO_COPY, x.numel() // S, r, S.bit_length() - 1, None, logc,
            c, None)
    assert rc == 0
    return out


def _host_cross(host_lib, x, partner, tb, C, s, c, inverse):
    S = tb.n // C
    out = torch.empty_like(x)
    assert host_lib.ntt_cross_stage(
        x.data_ptr(), partner.data_ptr(), out.data_ptr(), *tb.kernel_args(),
        int(inverse), int(sh.u_side(C, s, c)), sh.cross_twiddle(C, s, c),
        x.numel() // S, tb.r, S.bit_length() - 1, sh.log2_shards(C),
        None) == 0
    return out


def _check_host(host_lib, tb, x, y, C):
    """Every shard's launches of the host build against coef_kernels'
    plain versions, stage by stage."""
    logc = sh.log2_shards(C)
    xs = _split(x, C)
    for s in range(logc):
        got = _cross(xs, C, s, lambda a, b, c: _host_cross(
            host_lib, a, b, tb, C, s, c, False))
        xs = _cross(xs, C, s, lambda a, b, c: ck.cross_stage(
            a, b, tb, C, s, c, inverse=False))
        for g, w in zip(got, xs):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    for c in range(C):
        torch.testing.assert_close(
            _host_local(host_lib, xs[c], None, tb, logc, c, False),
            ck.local_forward(xs[c], tb, logc, c), rtol=0, atol=0)
    ys = _split(y, C)
    xs = [ck.local_inverse_mul(v, ys[c], tb, logc, c)
          for c, v in enumerate(_split(x, C))]
    for c, v in enumerate(_split(x, C)):
        torch.testing.assert_close(
            _host_local(host_lib, v, ys[c], tb, logc, c, True), xs[c],
            rtol=0, atol=0)
    for s in reversed(range(logc)):
        got = _cross(xs, C, s, lambda a, b, c: _host_cross(
            host_lib, a, b, tb, C, s, c, True))
        xs = _cross(xs, C, s, lambda a, b, c: ck.cross_stage(
            a, b, tb, C, s, c, inverse=True))
        for g, w in zip(got, xs):
            torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("C", [2, 4])
def test_host_shard_offset(host_lib, p4k, C):
    tb, x, y, _ = p4k
    _check_host(host_lib, tb, x, y, C)


def test_host_shard_offset_local_2p15(host_lib):
    """n = 65536 over C = 2: each shard's local 2^15 is the split schedule
    (one 55-bit modulus, a host call on tensors, no BFV)."""
    p = primegen.make_bfv_params(65536, 55, 1)
    tb = ntt.tables_for(p, device="cpu")
    rng = np.random.default_rng(65536)
    x, y = (torch.from_numpy(rng.integers(0, p.q[0], (1, p.n),
                                          dtype=np.int64))
            for _ in range(2))
    _check_host(host_lib, tb, x, y, 2)
