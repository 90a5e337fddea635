"""The port's Galois automorphisms and batching encoder against the JAX
package, on the CPU at n = 2048 with generated parameters (three 45-bit
moduli) and the batching prime t = 65537.  Every comparison is exact.

1. `poly.galois_maps`, `sampling.galois_draws` (element-indexed streams
   under key byte 0x03), `galois_keygen` for {3, 9, 2n - 1},
   `apply_galois`, `rotate_rows`, `rotate_columns` and the encoder's
   `encode`/`decode` are bit-identical to `ntt_cuda_tpu`
   (BFVContext.build(p, backend="xla")).  JAX unrolls galois_keygen's
   element loop under jit, so its keys are made once, for three elements.
2. A second galois_keygen call at the same nonce reproduces a shared
   element's key; relin_keygen's keys, now from the shared switching-key
   helper, are still the JAX package's.
3. The rotations act on the slots as SEAL's do, a batch equals its
   messages, and the port's encrypted dot product (the example) is right.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntt_cuda_tpu.models import bfv as jbfv
from ntt_cuda_tpu.models import encoder as jencoder
from ntt_cuda_tpu.ops import modmath as jmm
from ntt_cuda_tpu.ops import poly as jpoly
from ntt_cuda_tpu.ops import sampling as jsampling
from ntt_cuda_tpu.utils import primegen as jprimegen
from ntt_cuda_tpu_torch import BFVContext, convert
from ntt_cuda_tpu_torch.examples import encrypted_dot_product as example
from ntt_cuda_tpu_torch.models import encoder
from ntt_cuda_tpu_torch.ops import modmath, poly, sampling
from ntt_cuda_tpu_torch.utils import primegen

N = 2048
ELTS = (3, 9, 2 * N - 1)        # rotations by 1 and 2, the column swap


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (the suite runs several
    worker processes at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _eq(got, ref):
    np.testing.assert_array_equal(convert.to_numpy(got), np.asarray(ref))


@pytest.fixture(scope="module")
def setup():
    """Both packages' contexts, keys (nonce 2), Galois keys for ELTS
    (nonce 5), encoders and a ciphertext of seeded slot values (nonce 3)."""
    t = primegen.find_plain_modulus(N, 17)
    p = primegen.make_bfv_params(N, 45, 3, t=t)
    jp = jprimegen.make_bfv_params(N, 45, 3, t=t)
    jctx = jbfv.BFVContext.build(jp, backend="xla")
    ctx = BFVContext.build(p, device="cpu")
    jsk, jpk = jctx.keygen(nonce=2)
    sk, pk = ctx.keygen(nonce=2)
    jenc, enc = jencoder.BatchEncoder(jp), encoder.BatchEncoder(p,
                                                                device="cpu")
    v = np.random.default_rng(9).integers(0, t, N, dtype=np.uint64)
    jm, m = jenc.encode(jnp.asarray(v)), enc.encode(v)
    return dict(p=p, jctx=jctx, ctx=ctx, jsk=jsk, sk=sk, jpk=jpk, pk=pk,
                jenc=jenc, enc=enc, v=v, jm=jm, m=m,
                jgks=jctx.galois_keygen(jsk, ELTS, nonce=5),
                gks=ctx.galois_keygen(sk, ELTS, nonce=5),
                jct=jctx.encrypt(jpk, jm, nonce=3),
                ct=ctx.encrypt(pk, m, nonce=3))


@pytest.mark.parametrize("g", [1, 3, 9, 5, 2 * N - 1, 2 * N - 3])
def test_galois_maps_match_jax(g):
    perm, neg = poly.galois_maps(N, g)
    jperm, jneg = jpoly.galois_maps(N, g)
    np.testing.assert_array_equal(perm, jperm)
    np.testing.assert_array_equal(neg, jneg)
    assert perm.dtype == jperm.dtype and neg.dtype == jneg.dtype


@pytest.mark.parametrize("g", [0, 2, 2 * N, 2 * N + 1])
def test_galois_maps_reject_elements(g):
    with pytest.raises(ValueError, match="galois element"):
        poly.galois_maps(N, g)


def test_galois_draws_match_jax(setup):
    p = setup["p"]
    k = p.r - 1
    a, e = sampling.galois_draws(p.n, p.r, k, (3, 2 * N - 1),
                                 modmath.modulus_set(p), nonce=5)
    ja, je = jsampling.galois_draws(p.n, p.r, k, (3, 2 * N - 1),
                                    jmm.modulus_set(p), nonce=5,
                                    ks_impl="xla")
    assert tuple(a.shape) == (2, k, p.r, p.n)
    _eq(a, ja)
    _eq(e, je)


def test_galois_keygen_matches_jax(setup):
    gks, jgks = setup["gks"], setup["jgks"]
    p = setup["p"]
    assert sorted(gks) == sorted(jgks) == sorted(ELTS)
    for g in ELTS:
        assert tuple(gks[g].shape) == (2, p.r - 1, p.r, p.n)
        _eq(gks[g], jgks[g])


def test_galois_keygen_shared_element_reproduces(setup):
    """Streams are indexed by element value: {9, 5} at nonce 5 gives 9 the
    key of {3, 9, 2n - 1} at nonce 5; another nonce does not."""
    ctx, sk, gks = setup["ctx"], setup["sk"], setup["gks"]
    again = ctx.galois_keygen(sk, [9, 5], nonce=5)
    assert torch.equal(again[9], gks[9])
    assert not torch.equal(again[5][1], gks[9][1])
    assert not torch.equal(ctx.galois_keygen(sk, [9], nonce=6)[9], gks[9])


def test_relin_keygen_matches_jax(setup):
    """relin_keygen through the shared switching-key helper."""
    _eq(setup["ctx"].relin_keygen(setup["sk"], nonce=4),
        setup["jctx"].relin_keygen(setup["jsk"], nonce=4))


def test_encoder_matches_jax(setup):
    enc, jenc = setup["enc"], setup["jenc"]
    _eq(setup["m"], setup["jm"])
    _eq(enc.decode(setup["m"]), jenc.decode(setup["jm"]))
    np.testing.assert_array_equal(enc.decode(setup["m"]).numpy(),
                                  setup["v"].astype(np.int64))
    _eq(setup["ct"], setup["jct"])


def test_apply_galois_and_rotations_match_jax(setup):
    ctx, jctx = setup["ctx"], setup["jctx"]
    ct, jct, gks, jgks = setup["ct"], setup["jct"], setup["gks"], \
        setup["jgks"]
    for g in ELTS:
        _eq(ctx.apply_galois(ct, g, gks[g]),
            jctx.apply_galois(jct, g, jgks[g]))
    for steps in (1, 2):
        _eq(ctx.rotate_rows(ct, steps, gks),
            jctx.rotate_rows(jct, steps, jgks))
    _eq(ctx.rotate_columns(ct, gks), jctx.rotate_columns(jct, jgks))


def test_rotations_act_on_slots(setup):
    """rotate_rows(1) moves each row's slots left by one, rotate_columns
    swaps the rows, and apply_galois decrypts to tau_g(m) mod t."""
    ctx, enc, sk, ct, gks = (setup[k] for k in ("ctx", "enc", "sk", "ct",
                                                "gks"))
    v = torch.from_numpy(setup["v"].astype(np.int64)).reshape(2, N // 2)
    rows = enc.decode(ctx.decrypt(sk, ctx.rotate_rows(ct, 1, gks)))
    assert torch.equal(rows.reshape(2, N // 2), torch.roll(v, -1, dims=1))
    cols = enc.decode(ctx.decrypt(sk, ctx.rotate_columns(ct, gks)))
    assert torch.equal(cols.reshape(2, N // 2), v.flip(0))
    t = setup["p"].t
    perm, neg = poly.galois_maps(N, 9)
    m = setup["m"][torch.from_numpy(perm.astype(np.int64))]
    want = torch.where(torch.from_numpy(neg), (t - m) % t, m)
    assert torch.equal(ctx.decrypt(sk, ctx.apply_galois(ct, 9, gks[9])), want)


def test_apply_galois_batch_and_errors(setup):
    ctx, pk, gks = setup["ctx"], setup["pk"], setup["gks"]
    cts = torch.stack([setup["ct"], ctx.encrypt(pk, setup["m"], nonce=4)])
    batched = ctx.apply_galois(cts, 3, gks[3])
    for j in range(2):
        assert torch.equal(batched[j], ctx.apply_galois(cts[j], 3, gks[3]))
    with pytest.raises(ValueError, match="gk"):
        ctx.apply_galois(setup["ct"], 3, gks[3][0])
    with pytest.raises(ValueError, match="galois element"):
        ctx.galois_keygen(setup["sk"], [4])
    with pytest.raises(KeyError, match="rotation element"):
        ctx.rotate_rows(setup["ct"], 3, gks)
    with pytest.raises(ValueError, match="prime plaintext modulus"):
        encoder.BatchEncoder(primegen.make_bfv_params(N, 45, 3),
                             device="cpu")


def test_example_dot_product():
    """The port's example at n = 2048: every slot holds the dot product,
    with noise budget to spare."""
    out = example.encrypted_dot_product(n=N, verbose=False, device="cpu")
    assert out["result"] == out["expected"]
    assert torch.equal(out["slots"], torch.full((N,), out["expected"]))
    assert out["budget"] > 0


def test_no_card_raises(monkeypatch):
    """With no card and no device asked for, the entry points raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = primegen.make_bfv_params(N, 45, 3, t=primegen.find_plain_modulus(N,
                                                                        17))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        encoder.BatchEncoder(p)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example.encrypted_dot_product(n=N, verbose=False)
