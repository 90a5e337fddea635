"""The port's 30-bit family transform (ntt_cuda_tpu_torch.ops.ntt30,
kernel 22's plain version) against the JAX package, on the CPU.

Every comparison is exact (tolerance 0); inputs are seeded numpy residues.

1. Forward and inverse equal `ntt.ntt_forward_jit` / `ntt_inverse_jit` (the
   64-bit XLA transform) on the family's modulus at n = 2048 ... 65536, and
   the round trip returns the input.
2. At n = 2048 they equal `ntt_pallas30.ntt_forward` / `ntt_inverse`, the
   TPU kernel in interpret mode (slow, so only there).
3. The dtype and shape contract of `_dispatch30`: int32 or int64 in, the
   same dtype out, a batch of (3, 1, 4096); what it refuses raises.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntt_cuda_tpu.ops import modmath as jmm
from ntt_cuda_tpu.ops import ntt as jntt
from ntt_cuda_tpu.ops import ntt_pallas30
from ntt_cuda_tpu.params import get_params as jget_params
from ntt_cuda_tpu_torch import convert
from ntt_cuda_tpu_torch.ops import ntt30
from ntt_cuda_tpu_torch.params import get_params
from ntt_cuda_tpu_torch.utils import primegen


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (the suite runs several
    worker processes at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _family(n):
    q, psi, *_ = get_params(n, "30bit")
    assert (q, psi) == jget_params(n, family="30bit")[:2]
    return q, psi


def _two_moduli(n):
    """Two 30-bit primes q === 1 mod 2n (below 2^30) and their psi."""
    qs = primegen.generate_moduli(n, 30, 2)
    return qs, [primegen.find_primitive_2n_root(q, n) for q in qs]


def _residues(n, lead, seed):
    q, _ = _family(n)
    return np.random.default_rng(seed).integers(0, q, lead + (n,),
                                                dtype=np.uint64)


@pytest.mark.parametrize("n", [2048, 8192, 32768, 65536])
def test_plain_matches_xla(n):
    q, psi = _family(n)
    t30 = ntt30.NTTTables30.build([q], [psi], n, device="cpu")
    jt = jntt.NTTTables.build([q], [psi], n)
    jms = jmm.ModulusSet.from_moduli([q])
    x = _residues(n, (1,), n)
    ref_f = np.asarray(jntt.ntt_forward_jit(jnp.asarray(x), jt, jms))
    got_f = ntt30.ntt_forward(convert.to_torch(x, device="cpu"), t30)
    np.testing.assert_array_equal(convert.to_numpy(got_f), ref_f)
    ref_i = np.asarray(jntt.ntt_inverse_jit(jnp.asarray(ref_f), jt, jms))
    got_i = ntt30.ntt_inverse(got_f, t30)
    np.testing.assert_array_equal(convert.to_numpy(got_i), ref_i)
    np.testing.assert_array_equal(ref_i, x)


def test_plain_matches_pallas_interpret():
    n = 2048
    q, psi = _family(n)
    t30 = ntt30.NTTTables30.build([q], [psi], n, device="cpu")
    jt30 = ntt_pallas30.FourStepTables30.build([q], [psi], n)
    x = _residues(n, (2, 1), 7)
    ref_f = np.asarray(ntt_pallas30.ntt_forward(jnp.asarray(x), jt30,
                                                interpret=True))
    got_f = ntt30.ntt_forward(convert.to_torch(x, device="cpu"), t30)
    np.testing.assert_array_equal(convert.to_numpy(got_f), ref_f)
    ref_i = np.asarray(ntt_pallas30.ntt_inverse(jnp.asarray(ref_f), jt30,
                                                interpret=True))
    np.testing.assert_array_equal(
        convert.to_numpy(ntt30.ntt_inverse(got_f, t30)), ref_i)


def test_dtype_contract_on_a_batch():
    """(3, 1, 4096): int32 in -> int32 out, int64 -> int64, both equal to
    the JAX xla transform of the batch (as test_ntt_pallas30's u32 case)."""
    n = 4096
    q, psi = _family(n)
    t30 = ntt30.NTTTables30.build([q], [psi], n, device="cpu")
    x = _residues(n, (3, 1), 11)
    ref = np.asarray(jntt.ntt_forward_jit(
        jnp.asarray(x), jntt.NTTTables.build([q], [psi], n),
        jmm.ModulusSet.from_moduli([q])))
    x64 = convert.to_torch(x, device="cpu")
    got64 = ntt30.ntt_forward(x64, t30)
    got32 = ntt30.ntt_forward(x64.to(torch.int32), t30)
    assert got64.dtype == torch.int64 and got32.dtype == torch.int32
    assert got64.shape == got32.shape == (3, 1, n)
    np.testing.assert_array_equal(convert.to_numpy(got64), ref)
    np.testing.assert_array_equal(got32.numpy().astype(np.uint64), ref)
    back = ntt30.ntt_inverse(got32, t30)
    assert back.dtype == torch.int32
    assert torch.equal(back.to(torch.int64), x64)


def test_contract_refusals():
    n = 2048
    t2 = ntt30.NTTTables30.build(*_two_moduli(n), n, device="cpu")
    x = torch.zeros((3, n), dtype=torch.int64)
    with pytest.raises(ValueError, match="multiple of r=2"):
        ntt30.ntt_forward(x, t2)
    with pytest.raises(ValueError, match="expected shape"):
        ntt30.ntt_forward(torch.zeros((2, n // 2), dtype=torch.int64), t2)
    with pytest.raises(TypeError, match="int32 or int64"):
        ntt30.ntt_inverse(torch.zeros((2, n), dtype=torch.float64), t2)
    with pytest.raises(ValueError, match="q < 2\\^30"):
        ntt30.NTTTables30.build([get_params(n)[0]], [get_params(n)[1]], n,
                                device="cpu")
    with pytest.raises(ValueError, match="no kernel for meta"):
        ntt30.ntt_forward(torch.zeros((2, n), dtype=torch.int64,
                                      device="meta"), t2)


def test_two_moduli_rows_take_modulus_p_mod_r():
    """A (2, 2, n) batch over two moduli equals each modulus's rows
    transformed alone."""
    n = 2048
    qs, psis = _two_moduli(n)
    t2 = ntt30.NTTTables30.build(qs, psis, n, device="cpu")
    rng = np.random.default_rng(5)
    x = torch.from_numpy(np.stack(
        [rng.integers(0, qq, (2, n)) for qq in qs], axis=1))
    got = ntt30.ntt_forward(x, t2)
    for i, (qq, pp) in enumerate(zip(qs, psis)):
        one = ntt30.NTTTables30.build([qq], [pp], n, device="cpu")
        assert torch.equal(got[:, i], ntt30.ntt_forward(x[:, i], one))
    assert torch.equal(ntt30.ntt_inverse(got, t2), x)


def test_n65536_roundtrip():
    """The size only the 30-bit family publishes (parameter.h:129-136)."""
    n = 65536
    q, psi = _family(n)
    t30 = ntt30.NTTTables30.build([q], [psi], n, device="cpu")
    x = torch.from_numpy(_residues(n, (2, 1), 3).astype(np.int32))
    f = ntt30.ntt_forward(x, t30)
    assert not torch.equal(f, x)
    assert torch.equal(ntt30.ntt_inverse(f, t30), x)
