"""The plain reference against the library's plain (CPU) path at 4k_3q,
and the control (products through float64) against the reference."""

import pytest
import torch

from ntt_cuda_tpu_torch import BFVContext, get_bfv_params
from portbench.reference.bfv_ref import RefContext, is_prime, root_2n

P = get_bfv_params("4k_3q")
CFG = dict(name="4k_3q", n=P.n, q=list(P.q), psi=list(P.psi), t=P.t,
           gamma=P.gamma)


@pytest.fixture(scope="module")
def both():
    return (BFVContext.build(P, device="cpu", fusion="op"),
            RefContext(CFG, "cpu"))


def test_reference_equals_the_library_word_for_word(both):
    ctx, ref = both
    sk, pk = ctx.keygen(2 ** 40 + 5)
    rsk, rpk = ref.keygen(2 ** 40 + 5)
    assert torch.equal(sk, rsk) and torch.equal(pk, rpk)
    m = torch.randint(0, P.t, (3, P.n), generator=torch.Generator()
                      .manual_seed(3))
    nonces = [2 ** 50 + 1, 2 ** 50 + 2, 17]
    ct = ctx.encrypt_batch(pk, m, nonces)
    rct = ref.encrypt(rpk, m, nonces)
    assert torch.equal(ct, rct)
    assert torch.equal(ref.decrypt(rsk, rct), m)
    assert torch.equal(ctx.decrypt_batch(sk, ct), m)
    rlk = ctx.relin_keygen(sk, 9)
    rrlk = ref.relin_keygen(rsk, 9)
    assert torch.equal(rlk, rrlk)
    out = ctx.mul(ct[:2], ct[1:], rlk=rlk)
    assert torch.equal(out, ref.relinearize(ref.mul(rct[:2], rct[1:]), rrlk))


def test_control_breaks_exactness(both):
    _, ref = both
    low = RefContext(CFG, "cpu", fp64=True)
    sk, pk = ref.keygen(1)
    m = torch.zeros((1, P.n), dtype=torch.int64)
    ct = ref.encrypt(pk, m, [5])
    assert int((low.encrypt(pk, m, [5]) != ct).sum()) > 0
    assert int((low.decrypt(sk, ct) != m).sum()) > 0


def test_aux_primes_and_roots():
    assert is_prime(2 ** 61 - 1) and not is_prime(2 ** 61 + 1)
    q = P.q[0]
    psi = root_2n(q, P.n)
    assert pow(psi, P.n, q) == q - 1
