"""The port's stage schedule (ntt_cuda_tpu_torch.ops.ntt_stage,
bfv_tail.encrypt_fused, BFVContext fusion="stage") against the JAX
package, on the CPU.  Every comparison is exact (tolerance 0).

1. The plain version of each stage kernel against the JAX package's xla
   composition of the same function (its `ops/ntt.py` transforms, dyadic
   product and poly ops, which JAX's own tests hold equal to its Pallas
   kernels), at 4k_3q: one JAX call at J = 2 checks the port at J = 2 and,
   on its first message, at J = 1; the stage encrypt against JAX's Pallas
   kernel in interpret mode.
2. The plain transforms against the JAX `ops/ntt.py` at n = 32768.
3. keygen / encrypt / decrypt / decrypt_batch under fusion="stage" against
   the JAX xla pipelines at 4k_3q and 8k_4q; the golden dec4k ciphertext;
   a 32k_9q round trip.
4. Shapes are explicit: a mismatch raises, and a tensor on a device with
   no kernel raises instead of falling back.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntt_cuda_tpu.models import bfv as jbfv
from ntt_cuda_tpu.ops import bfv_tail as jtail
from ntt_cuda_tpu.ops import modmath as jmm
from ntt_cuda_tpu.ops import ntt as jntt
from ntt_cuda_tpu.ops import ntt_pallas
from ntt_cuda_tpu.ops import poly as jpoly
from ntt_cuda_tpu.params import get_bfv_params as jget
from ntt_cuda_tpu_torch import BFVContext, convert, get_bfv_params
from ntt_cuda_tpu_torch.ops import bfv_tail, ntt, ntt_stage


FIX = Path(__file__).parent / "fixtures"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in
    several worker processes at once, and oversubscribed torch threads slow
    the 32k plain transforms by two orders of magnitude."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rand(rng, qs, n, lead=()):
    return np.stack([rng.integers(0, q, lead + (n,), dtype=np.uint64)
                     for q in qs], axis=-2)


def _eq(got, ref):
    np.testing.assert_array_equal(convert.to_numpy(got), np.asarray(ref))


@pytest.fixture(scope="module")
def k4():
    """(JAX params, JAX four-step tables, port stage context) at 4k_3q."""
    jp = jget("4k_3q")
    return (jp, ntt_pallas.tables_for(jp),
            BFVContext.build(convert.params_from(jp), device="cpu",
                             fusion="stage"))


# --- 1. each kernel's plain version against the JAX Pallas kernel ------------

def _inputs(jp, seed):
    rng = np.random.default_rng(seed)
    x = _rand(rng, jp.q, jp.n, (2,))
    y = _rand(rng, jp.q, jp.n)
    tern = rng.integers(-1, 3, (2, jp.n)).astype(np.int32)
    gauss = rng.integers(-19, 17, (2, jp.n)).astype(np.int32)
    x[0, :, 0] = np.array(jp.q, dtype=np.uint64) - np.uint64(1)
    gauss[0, 0] = 1                     # x + e == q: the 0 fixup
    return x, y, tern, gauss


# name -> (port plain version, argument builder)
KERNELS = {
    "forward": (ntt_stage.ntt_forward_plain, lambda x, y, t, g: (x,)),
    "inverse": (ntt_stage.ntt_inverse_plain, lambda x, y, t, g: (x,)),
    "inverse_mul": (ntt_stage.ntt_inverse_mul_plain,
                    lambda x, y, t, g: (x, y)),
    "forward_ternary": (ntt_stage.ntt_forward_ternary_plain,
                        lambda x, y, t, g: (t,)),
    "forward_addneg_gauss": (ntt_stage.ntt_forward_addneg_gauss_plain,
                             lambda x, y, t, g: (x, g)),
}


def _xla_ref(jp, name, x, y, t, g):
    """JAX's xla composition of kernel `name` on the same inputs; a
    compact draw d maps to q + d for d < 0 (sampling.ternary / gaussian)."""
    jt, jms = jntt.tables_for(jp), jmm.modulus_set(jp)
    q = np.array(jp.q, np.int64)[:, None]

    def res(d):
        d = d[..., None, :].astype(np.int64)
        return jnp.asarray(np.where(d < 0, q + d, d).astype(np.uint64))

    def fwd(v):
        return jntt.ntt_forward_jit(v, jt, jms)
    x, y = jnp.asarray(x), jnp.asarray(y)
    return np.asarray({
        "forward": lambda: fwd(x),
        "inverse": lambda: jntt.ntt_inverse_jit(x, jt, jms),
        "inverse_mul": lambda: jntt.ntt_inverse_jit(
            jntt.dyadic_mul_jit(x, y, jms), jt, jms),
        "forward_ternary": lambda: fwd(res(t)),
        "forward_addneg_gauss": lambda: fwd(jpoly.poly_add_negate(
            x, res(g), jms)),
    }[name]())


def _to_port(a):
    return (torch.from_numpy(a) if a.dtype == np.int32
            else convert.to_torch(a, device="cpu"))


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_stage_plain_matches_pallas(k4, name):
    """Each stage kernel's plain version against JAX's xla composition of
    the same function, not the Pallas kernel itself: JAX's own tests hold
    that composition equal to the Pallas kernel (the name is the test's
    first form, which ran the kernel in interpret mode)."""
    jp, _, ctx = k4
    plain, args = KERNELS[name]
    x, y, t, g = _inputs(jp, 3)
    a = args(x, y, t, g)
    ref = _xla_ref(jp, name, x, y, t, g)
    tb = ctx.tables_full
    _eq(plain(*[_to_port(v) for v in a], tb), ref)                 # J = 2
    one = [v if v is y else v[0] for v in a]     # y is shared by both
    _eq(plain(*[_to_port(v) for v in one], tb), ref[0])            # J = 1


def test_encrypt_fused_plain_matches_pallas(k4):
    jp, ftab, ctx = k4
    rng = np.random.default_rng(5)
    u_ntt = _rand(rng, jp.q, jp.n)
    pk = np.stack([_rand(rng, jp.q, jp.n), _rand(rng, jp.q, jp.n)])
    e_d = rng.integers(-19, 17, (2, jp.n)).astype(np.int32)
    m = rng.integers(0, jp.t, jp.n, dtype=np.uint64)
    m[:4] = [0, jp.t - 1, jp.t // 2, (jp.t + 1) // 2]
    ref = jtail.encrypt_fused(jnp.asarray(u_ntt), jnp.asarray(pk),
                              jnp.asarray(e_d), jnp.asarray(m), ftab,
                              jtail.TailConsts.build(jp), interpret=True)
    got = bfv_tail.encrypt_fused_plain(
        convert.to_torch(u_ntt, device="cpu"),
        convert.to_torch(pk, device="cpu"), torch.from_numpy(e_d),
        convert.to_torch(m, device="cpu"), ctx.tables_full,
        ctx.tail_consts)
    _eq(got, ref)
    _eq(bfv_tail.encrypt_fused(
        convert.to_torch(u_ntt, device="cpu"),
        convert.to_torch(pk, device="cpu"), torch.from_numpy(e_d),
        convert.to_torch(m, device="cpu"), ctx.tables_full,
        ctx.tail_consts), ref)


# --- 2. the plain transforms at n = 32768 ------------------------------------

@pytest.mark.parametrize("moduli", [(0, 8)], ids=["q0_q8"])
def test_plain_transforms_at_32k(moduli):
    jp = jget("32k_9q")
    qs = [jp.q[i] for i in moduli]
    psis = [jp.psi[i] for i in moduli]
    jt, jms = jntt.NTTTables.build(qs, psis, jp.n), jmm.ModulusSet.from_moduli(qs)
    tb = ntt.NTTTables.build(qs, psis, jp.n, device="cpu")
    x = _rand(np.random.default_rng(7), qs, jp.n)
    fwd = np.asarray(jntt.ntt_forward_jit(jnp.asarray(x), jt, jms))
    _eq(ntt_stage.ntt_forward_plain(convert.to_torch(x, device="cpu"), tb),
        fwd)
    inv = np.asarray(jntt.ntt_inverse_jit(jnp.asarray(x), jt, jms))
    _eq(ntt_stage.ntt_inverse_plain(convert.to_torch(x, device="cpu"), tb),
        inv)
    _eq(ntt_stage.ntt_inverse_plain(convert.to_torch(fwd, device="cpu"),
                                    tb), x)


# --- 3. the stage schedule end to end ---------------------------------------

@pytest.fixture(scope="module", params=["4k_3q", "8k_4q"])
def pipeline(request):
    jp = jget(request.param)
    return (jbfv.BFVContext.build(jp, backend="xla"),
            BFVContext.build(convert.params_from(jp), device="cpu",
                             fusion="stage"))


@pytest.mark.parametrize("nonce", [0, 1, 2])
def test_stage_pipeline_matches_jax(pipeline, nonce):
    jctx, ctx = pipeline
    p = ctx.params
    assert ctx.fusion == "stage"
    jsk, jpk = (np.asarray(v) for v in jctx.keygen(nonce))
    sk, pk = ctx.keygen(nonce)
    _eq(sk, jsk)
    _eq(pk, jpk)
    msgs = np.random.default_rng(nonce).integers(0, p.t, (2, p.n),
                                                 dtype=np.uint64)
    jcts = np.stack([np.asarray(jctx.encrypt(jpk, msgs[j], nonce=nonce + j))
                     for j in range(2)])
    cts = torch.stack([ctx.encrypt(pk, msgs[j], nonce=nonce + j)
                       for j in range(2)])
    _eq(cts, jcts)
    for j in range(2):
        m = ctx.decrypt(sk, cts[j])
        _eq(m, jctx.decrypt(jsk, jcts[j]))
        _eq(m, msgs[j])
    _eq(ctx.decrypt_batch(sk, cts), jctx.decrypt_batch(jsk, jcts))


def test_stage_golden_decrypt():
    ctx = BFVContext.build(get_bfv_params("4k_3q"), device="cpu",
                           fusion="stage")
    ct = np.stack([np.load(FIX / "dec4k_c0.npy"), np.load(FIX / "dec4k_c1.npy")])
    m = ctx.decrypt(np.load(FIX / "dec4k_sk_ntt.npy"), ct)
    np.testing.assert_array_equal(m.numpy(), np.arange(ctx.params.n) % 10)


def test_32k_9q_roundtrip_and_auto_rule():
    """fusion="auto" takes the stage schedule above n = 16384, and the op
    schedule at and below it."""
    ctx = BFVContext.build(get_bfv_params("32k_9q"), device="cpu")
    assert ctx.fusion == "stage"
    assert BFVContext.build(get_bfv_params("16k_5q"),
                            device="cpu").fusion == "op"
    p = ctx.params
    msgs = np.random.default_rng(9).integers(0, p.t, (2, p.n))
    sk, pk = ctx.keygen(nonce=1)
    cts = torch.stack([ctx.encrypt(pk, msgs[j], nonce=j + 1)
                       for j in range(2)])
    assert cts.shape == (2, 2, p.r - 1, p.n)
    np.testing.assert_array_equal(ctx.decrypt(sk, cts[0]).numpy(), msgs[0])
    np.testing.assert_array_equal(ctx.decrypt_batch(sk, cts).numpy(), msgs)


# --- 4. explicit shapes, no fallback ----------------------------------------

def test_stage_wrappers_check_shapes(k4):
    _, _, ctx = k4
    tb = ctx.tables_full
    r, n = tb.r, tb.n
    x = torch.zeros((2, r, n), dtype=torch.int64)
    d = torch.zeros((2, n), dtype=torch.int32)
    with pytest.raises(ValueError, match=r"x: expected shape"):
        ntt_stage.ntt_forward(x.reshape(2 * r, n), tb)   # a flat (J r) batch
    with pytest.raises(ValueError, match=r"y: expected shape"):
        ntt_stage.ntt_inverse_mul(x, x[:1], tb)
    with pytest.raises(ValueError, match=r"e_d: shape"):
        ntt_stage.ntt_forward_addneg_gauss(x, d[0], tb)  # J = 2 vs one row
    with pytest.raises(ValueError, match=r"e: shape"):
        ntt_stage.ntt_forward_addneg(x, x[0], tb)        # e read at x's index
    with pytest.raises(TypeError, match=r"int32"):
        ntt_stage.ntt_forward_ternary(d.to(torch.int64), tb)
    with pytest.raises(ValueError, match=r"u_b: expected shape"):
        ntt_stage.ntt_forward_ternary(d[:, : n // 2], tb)
    with pytest.raises(ValueError, match=r"e_d: expected shape"):
        bfv_tail.encrypt_fused(x[0], x, d[:1], torch.zeros(n, dtype=torch.int64),
                               tb, ctx.tail_consts)
    # a device with no kernel raises; nothing falls back to the plain version
    with pytest.raises(ValueError, match="no kernel for meta"):
        ntt_stage.ntt_forward(x.to("meta"), tb)
