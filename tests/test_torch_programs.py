"""The port's op programs (BFVContext.op_programs / mult_program) against
the JAX package on the CPU at 4k_3q, tolerance 0 (the port of
tests/test_programs.py, nonces 5 and 6).

1. Every program function, under fusion "op" and "stage", equals the JAX
   package's public method (`backend="xla"`): kg / enc / dec with the full
   and the dropped sk, enc_batch / dec_batch at J = 2, mul with and
   without rlk, and square; also through `profiling.graphed` (its eager
   path on the CPU) and equal to the port's own public methods.
2. The device nonce maps against JAX's keygen_nonce / encrypt_nonce at 0,
   1, 2^63 - 1 and bit-63 patterns; the draws at a tensor nonce against
   the same draws at the int nonce.
3. The CLI's k = 3 chains (keygen carrying sk[0, 0] + pk[0, 0, 0] +
   pk[1, 0, 0] into its nonce, encrypt taking its nonce from ct[0, 0, 0],
   decrypt perturbing ct[0, 0, 0]) against the same chains built from
   JAX's op_programs under jax.jit + lax.fori_loop.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntt_cuda_tpu.models import bfv as jbfv
from ntt_cuda_tpu.ops import sampling as jsamp
from ntt_cuda_tpu.params import get_bfv_params as jget
from ntt_cuda_tpu_torch import BFVContext, cli, convert, get_bfv_params
from ntt_cuda_tpu_torch.ops import sampling
from ntt_cuda_tpu_torch.utils import profiling

CHAIN = 3
EDGES = [0, 1, 2**63 - 1, 2**63, 2**63 + 5, 2**64 - 1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in
    several worker processes at once, and oversubscribed torch threads slow
    the plain transforms by orders of magnitude."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _eq(got, ref):
    np.testing.assert_array_equal(convert.to_numpy(got), np.asarray(ref))


def _nonce(v: int) -> torch.Tensor:
    """A u64 as the () int64 tensor of its bit pattern."""
    return torch.tensor(np.uint64(v).view(np.int64))


def _nonces(vs) -> torch.Tensor:
    return torch.from_numpy(np.asarray(vs, np.uint64).view(np.int64))


@pytest.fixture(scope="module")
def ref():
    """The JAX package's outputs at 4k_3q (xla): keys at nonce 5, m
    encrypted at 6 (and 7), the J = 2 batch at nonces 7, 8, the
    relinearization key and the three products, and its k = 3 chains."""
    jctx = jbfv.BFVContext.build(jget("4k_3q"), backend="xla")
    p = jctx.params
    m = jnp.asarray(np.arange(p.n, dtype=np.uint64) % p.t)
    sk, pk = jctx.keygen(nonce=5)
    ct = jctx.encrypt(pk, m, nonce=6)
    ct2 = jctx.encrypt(pk, m, nonce=7)
    mb = jnp.stack([m, (m + 1) % jnp.uint64(p.t)])
    cts_b = jctx.encrypt_batch(pk, mb, jnp.asarray([7, 8], jnp.uint64))
    rlk = jctx.relin_keygen(sk)
    kg_fn, enc_fn, dec_fn, _, _, bz = jctx.op_programs()
    q0 = jnp.uint64(p.q[0])

    def kg_chain(seed):
        def body(_, s):
            skk, pkk = kg_fn(s, bz)
            return skk[0, 0] + pkk[0, 0, 0] + pkk[1, 0, 0]
        return jax.lax.fori_loop(0, CHAIN, body, seed)

    def enc_chain(c):
        return jax.lax.fori_loop(
            0, CHAIN, lambda _, cc: enc_fn(cc[0, 0, 0], pk, m, bz), c)

    def dec_chain(c):
        def body(_, cc):
            out = dec_fn(sk, cc, bz)
            return cc.at[0, 0, 0].set((cc[0, 0, 0] + out[0]) % q0)
        return jax.lax.fori_loop(0, CHAIN, body, c)

    out = dict(m=m, sk=sk, pk=pk, ct=ct, ct2=ct2, mb=mb, cts_b=cts_b,
               rlk=rlk, mul_rlk=jctx.mul(ct, ct2, rlk=rlk),
               mul3=jctx.mul(ct, ct2), square_rlk=jctx.square(ct, rlk=rlk),
               kg_chain=jax.jit(kg_chain)(jnp.uint64(1)),
               enc_chain=jax.jit(enc_chain)(ct),
               dec_chain=jax.jit(dec_chain)(ct))
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module", params=["op", "stage"])
def port(request):
    """The port's context under one schedule, its programs, and the JAX
    reference's keys, ciphertexts and messages as tensors."""
    ctx = BFVContext.build(get_bfv_params("4k_3q"), device="cpu",
                           fusion=request.param)
    return ctx, ctx.op_programs(), ctx.mult_program()


def _t(ref, key):
    return convert.to_torch(ref[key], device="cpu")


def test_op_programs_match_jax(port, ref):
    ctx, (kg_fn, enc_fn, dec_fn, _, _, bz), _ = port
    sk, pk = kg_fn(_nonce(5), bz)
    _eq(sk, ref["sk"])
    _eq(pk, ref["pk"])
    m = _t(ref, "m")
    ct = enc_fn(_nonce(6), pk, m, bz)
    _eq(ct, ref["ct"])
    assert torch.equal(ct, ctx.encrypt(pk, m, nonce=6))
    for key in (sk, sk[: ctx.params.r - 1]):        # full and dropped sk
        out = dec_fn(key, ct, bz)
        _eq(out, ref["m"])
        assert torch.equal(out, ctx.decrypt(key, ct))


def test_batch_programs_match_jax(port, ref):
    ctx, (_, _, _, encb_fn, decb_fn, bz), _ = port
    pk, sk, mb = _t(ref, "pk"), _t(ref, "sk"), _t(ref, "mb")
    cts = encb_fn(_nonces([7, 8]), pk, mb, bz)
    _eq(cts, ref["cts_b"])
    assert torch.equal(cts, ctx.encrypt_batch(pk, mb, [7, 8]))
    for key in (sk, sk[: ctx.params.r - 1]):
        outs = decb_fn(key, cts, bz)
        _eq(outs, ref["mb"])
        assert torch.equal(outs, ctx.decrypt_batch(key, cts))


@pytest.mark.parametrize("form", ["mul_rlk", "mul3", "square_rlk"])
def test_mult_program_matches_jax(port, ref, form):
    ctx, _, (mul_fn, square_fn, bz) = port
    ct, ct2, rlk = _t(ref, "ct"), _t(ref, "ct2"), _t(ref, "rlk")
    if form == "square_rlk":
        got, mine = square_fn(ct, rlk, bz), ctx.square(ct, rlk=rlk)
    else:
        key = rlk if form == "mul_rlk" else None
        got, mine = mul_fn(ct, ct2, key, bz), ctx.mul(ct, ct2, rlk=key)
    _eq(got, ref[form])
    assert torch.equal(got, mine)


def test_graphed_programs_on_the_cpu(port, ref):
    """graphed's CPU path runs the function again at each call into its
    static outputs: a nonce copied into the static input takes effect."""
    ctx, (kg_fn, enc_fn, _, _, _, bz), _ = port
    nonce = _nonce(9)
    g = profiling.graphed(kg_fn, nonce, bz)
    sk9, pk9 = (t.clone() for t in g.outputs)
    nonce.copy_(_nonce(5))
    sk, pk = g()
    _eq(sk, ref["sk"])
    _eq(pk, ref["pk"])
    ref9 = ctx.keygen(nonce=9)
    assert torch.equal(sk9, ref9[0]) and torch.equal(pk9, ref9[1])
    e = profiling.graphed(enc_fn, _nonce(6), pk, _t(ref, "m"), bz)
    _eq(e(), ref["ct"])


def test_nonce_maps_match_jax():
    v = _nonces(EDGES)
    _eq(sampling.keygen_nonce_t(v), jsamp.keygen_nonce(
        jnp.asarray(EDGES, jnp.uint64)))
    _eq(sampling.encrypt_nonce_t(v), jsamp.encrypt_nonce(
        jnp.asarray(EDGES, jnp.uint64)))
    for x in EDGES:                               # () tensors and the ints
        assert int(np.int64(sampling.keygen_nonce_t(_nonce(x))).view(
            np.uint64)) == sampling.keygen_nonce(x)
        assert int(np.int64(sampling.encrypt_nonce_t(_nonce(x))).view(
            np.uint64)) == sampling.encrypt_nonce(x)


@pytest.mark.parametrize("x", EDGES)
def test_draws_at_a_tensor_nonce_equal_the_int_nonce(x):
    p = get_bfv_params("4k_3q")
    ms = BFVContext.build(p, device="cpu").tables_full.ms
    got = sampling.keygen_draws_compact(p.n, p.r, ms, nonce=_nonce(x))
    want = sampling.keygen_draws_compact(p.n, p.r, ms, nonce=x)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    got = sampling.encrypt_draws_compact(p.n, nonce=_nonce(x), device="cpu")
    want = sampling.encrypt_draws_compact(p.n, nonce=x, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    pair = [x, 7]
    got = sampling.encrypt_draws_compact_batch(p.n, _nonces(pair),
                                               device="cpu")
    want = sampling.encrypt_draws_compact_batch(p.n, pair, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_chains_match_jax_fori_loop(port, ref):
    """The CLI's chains, k = 3: the keygen carry, the encrypt chain's last
    ciphertext and the decrypt chain's perturbed ciphertext equal JAX's
    fori_loop carries."""
    ctx, _, _ = port
    sk, pk, m, ct = (_t(ref, k) for k in ("sk", "pk", "m", "ct"))
    kg_make, enc_make, dec_make = cli.phase_chains(ctx, sk, pk, m)
    _eq(kg_make(CHAIN)(torch.ones((), dtype=torch.int64)), ref["kg_chain"])
    _eq(enc_make(CHAIN)(ct), ref["enc_chain"])
    _eq(dec_make(CHAIN)(ct), ref["dec_chain"])
