"""keygen's reference-exact uniform spec (`uniform_spec="fp64"`) in the
port against the JAX package, on the CPU, exactly.

* `sampling.uniform_ref` (the reference's IEEE-double draw emulated in
  the port's int64-carried u64 integers) against the JAX package's
  `sampling.uniform_ref` on seeded words and the edges 0, 1, 2^53 - 1,
  2^53, 2^53 + 1, 2^63 and 2^64 - 1 (and the rounding ties around them),
  and against the host IEEE-double model (`golden.uniform_ref_double`);
* keygen at 4k_3q (op) and 8k_4q (stage) with `uniform_spec="fp64"`
  against `BFVContext.build(..., backend="xla", uniform_spec="fp64")`;
  `next_context` and the keygen program carry the spec.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ntt_cuda_tpu.models import bfv as jbfv
from ntt_cuda_tpu.ops import modmath as jmm
from ntt_cuda_tpu.ops import sampling as jsampling
from ntt_cuda_tpu.params import get_bfv_params as jget
from ntt_cuda_tpu_torch import BFVContext, convert, get_bfv_params
from ntt_cuda_tpu_torch.ops import modmath, salsa20, sampling
from ntt_cuda_tpu_torch.utils import golden, primegen

EDGES = [0, 1, 2**53 - 1, 2**53, 2**53 + 1, 2**63, 2**64 - 1,
         2**54 + 2, 2**54 + 6, 2**63 + 2**10, 2**63 + 3 * 2**10,
         2**64 - 2**10, 2**64 - 2**11, 2**64 - 2**11 - 1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in
    several worker processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _words(r, n, seed):
    u = np.random.default_rng(seed).integers(0, 2**64, (r, n),
                                             dtype=np.uint64)
    u[:, :len(EDGES)] = np.array(EDGES, dtype=np.uint64)
    return u


@pytest.mark.parametrize("name", ["4k_3q", "32k_16q"])
def test_uniform_ref_matches_jax(name):
    p = get_bfv_params(name)
    u = _words(p.r, 2048, 1)
    got = sampling.uniform_ref(torch.from_numpy(u.view(np.int64)),
                               modmath.modulus_set(p, device="cpu"))
    want = jsampling.uniform_ref(jnp.asarray(u), jmm.modulus_set(jget(name)))
    np.testing.assert_array_equal(convert.to_numpy(got), np.asarray(want))


def test_uniform_ref_edges_match_ieee_doubles():
    """The edges against the host IEEE-double model, at moduli of 50 to 62
    bits (q - 1 above 53 bits rounds; the quirk that the result can pass
    q - 1 included)."""
    qs = [get_bfv_params("16k_5q").q[0], get_bfv_params("32k_16q").q[-1],
          (1 << 62) - 57]
    u = np.array(EDGES, dtype=np.uint64)
    got = sampling.uniform_ref(
        torch.from_numpy(np.tile(u.view(np.int64), (len(qs), 1))),
        modmath.ModulusSet.from_moduli(qs, device="cpu"))
    for i, q in enumerate(qs):
        assert convert.to_numpy(got[i]).tolist() == \
            golden.uniform_ref_double(EDGES, q)


def test_keygen_draws_take_the_spec():
    """keygen_draws_compact's uniform rows are uniform_ref's of the same
    lanes under "fp64" and uniform's under "int" (60-bit moduli, where the
    two differ); the ternary and Gaussian draws do not read the spec."""
    p = primegen.make_bfv_params(1024, 60, 3)
    ms = modmath.modulus_set(p, device="cpu")
    fp = sampling.keygen_draws_compact(p.n, p.r, ms, nonce=2,
                                       uniform_spec="fp64")
    it = sampling.keygen_draws_compact(p.n, p.r, ms, nonce=2)
    assert torch.equal(fp[0], it[0]) and torch.equal(fp[2], it[2])
    ks = salsa20.keystream_words(
        -(-sampling.keygen_entropy_bytes(p.n, p.r) // 64),
        nonce=sampling.keygen_nonce(2), device="cpu")
    u = salsa20.bytes_u64(ks, p.n, p.r * p.n).reshape(p.r, p.n)
    assert torch.equal(fp[1], sampling.uniform_ref(u, ms))
    assert torch.equal(it[1], sampling.uniform(u, ms))
    assert not torch.equal(fp[1], it[1])


@pytest.mark.parametrize("name,fusion", [("4k_3q", "op"), ("8k_4q", "stage")])
def test_keygen_fp64_matches_jax(name, fusion):
    ctx = BFVContext.build(get_bfv_params(name), device="cpu",
                           uniform_spec="fp64", fusion=fusion)
    jctx = jbfv.BFVContext.build(jget(name), backend="xla",
                                 uniform_spec="fp64")
    sk, pk = ctx.keygen(3)
    jsk, jpk = jctx.keygen(3)
    np.testing.assert_array_equal(convert.to_numpy(sk), np.asarray(jsk))
    np.testing.assert_array_equal(convert.to_numpy(pk), np.asarray(jpk))
    if name == "4k_3q" and fusion == "op":
        kg_fn = ctx.op_programs()[0]
        bz = ctx.op_programs()[-1]
        for got, want in zip(kg_fn(torch.tensor(3), bz), (sk, pk)):
            assert torch.equal(got, want)
        assert ctx.next_context().uniform_spec == "fp64"
