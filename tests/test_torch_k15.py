"""The 32k_16q deployment (Table 7's (32768, 880, 16): sixteen moduli, so
BEHZ at k = 15 and the key switch over 15 digits) on the port's CPU path,
word for word against the benchmark's plain reference
(portbench/reference/bfv_ref.py, which shares nothing with the library)
and against the JAX package's XLA backend (keygen, relin_keygen and mul
with rlk).

The moduli are the published set's; n is cut to 1024 with the roots
psi^32 (a 2n-th root of each modulus), since the CPU path's cost grows
with n and what k = 15 changes (the conversions' linear forms, the
digits, the key's shape) does not depend on it.  At full width the
benchmark cell 32k_16q.mulrelin checks the same on the card."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from ntt_cuda_tpu.models import bfv as jbfv
from ntt_cuda_tpu.params import BFVParams as JBFVParams
from ntt_cuda_tpu_torch import BFVContext, convert, get_bfv_params
from ntt_cuda_tpu_torch.params import BFVParams
from portbench.reference.bfv_ref import RefContext

ROOT = Path(__file__).resolve().parents[1]
PUB = get_bfv_params("32k_16q")
N = 1024
P = BFVParams(name="32k_16q_n1024", n=N, q=PUB.q,
              psi=tuple(pow(s, PUB.n // N, q) for s, q in zip(PUB.psi, PUB.q)),
              t=PUB.t, gamma=PUB.gamma)
KEY_NONCE, RELIN_NONCE = 2 ** 40 + 5, 9
NONCES = [2 ** 50 + 1, 17]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs():
    """keygen, encrypt_batch of 2, relin_keygen and mul(a, b, rlk) on the
    port (the config's stage schedule) and on the reference."""
    ctx = BFVContext.build(P, device="cpu", fusion="stage")
    ref = RefContext(dict(name=P.name, n=N, q=list(P.q), psi=list(P.psi),
                          t=P.t, gamma=P.gamma), "cpu")
    m = torch.randint(0, P.t, (2, N), generator=torch.Generator()
                      .manual_seed(15))
    out = {}
    for name, keygen, enc, rlkg, mul in (
            ("port", ctx.keygen, ctx.encrypt_batch, ctx.relin_keygen,
             lambda a, b, rlk: ctx.mul(a, b, rlk=rlk)),
            ("ref", ref.keygen, ref.encrypt, ref.relin_keygen,
             lambda a, b, rlk: ref.relinearize(ref.mul(a, b), rlk))):
        sk, pk = keygen(KEY_NONCE)
        ct = enc(pk, m, NONCES)
        rlk = rlkg(sk, RELIN_NONCE)
        out[name] = dict(sk=sk, pk=pk, ct=ct, rlk=rlk,
                         prod=mul(ct[:1], ct[1:], rlk))
    out["dec"] = ctx.decrypt_batch(out["port"]["sk"], out["port"]["prod"])
    out["m"] = m
    return out


@pytest.fixture(scope="module")
def jax_run(runs):
    """The JAX package's XLA backend at the same set: relin_keygen of the
    port's secret key, and mul with that rlk of the port's two
    ciphertexts (keygen is held to the JAX package in test_torch_bfv.py)."""
    jctx = jbfv.BFVContext.build(JBFVParams(
        name=P.name, n=N, q=P.q, psi=P.psi, t=P.t, gamma=P.gamma),
        backend="xla")
    jrlk = jctx.relin_keygen(convert.to_numpy(runs["port"]["sk"]),
                             nonce=RELIN_NONCE)
    jct = convert.to_numpy(runs["port"]["ct"])
    return dict(rlk=np.asarray(jrlk),
                prod=np.asarray(jctx.mul(jct[0], jct[1], rlk=jrlk))[None])


def test_config_states_params_32k_16q():
    cfg = json.loads((ROOT / "portbench/configs/32k_16q.json").read_text())
    assert (cfg["n"], tuple(cfg["q"]), tuple(cfg["psi"]), cfg["t"],
            cfg["gamma"]) == (PUB.n, PUB.q, PUB.psi, PUB.t, PUB.gamma)
    assert len(cfg["q"]) == 16 and cfg["schedule"] == "stage"


def test_roots_at_1024():
    assert all(pow(s, N, q) == q - 1 for s, q in zip(P.psi, P.q))


@pytest.mark.parametrize("what", ["sk", "pk", "ct", "rlk", "prod"])
def test_port_equals_reference(runs, what):
    """Keys, the batch of two ciphertexts, the relinearization key (2, 15,
    16, n) and the relinearized product, word for word."""
    got, want = runs["port"][what], runs["ref"][what]
    assert got.shape == want.shape and torch.equal(got, want)


@pytest.mark.parametrize("what", ["rlk", "prod"])
def test_port_equals_jax(runs, jax_run, what):
    """The relinearization key (2, 15, 16, n) and the relinearized product,
    word for word against the JAX package."""
    got = convert.to_numpy(runs["port"][what])
    assert got.shape == jax_run[what].shape
    np.testing.assert_array_equal(got, jax_run[what])


def test_shapes_at_k15(runs):
    assert tuple(runs["port"]["rlk"].shape) == (2, 15, 16, N)
    assert tuple(runs["port"]["prod"].shape) == (1, 2, 15, N)


def test_product_decrypts_to_the_negacyclic_product(runs):
    a, b = (runs["m"][i].numpy() for i in (0, 1))
    full = np.convolve(a, b)                       # below 2^31 at t = 1024
    want = (full[:N] - np.append(full[N:], 0)) % P.t
    assert np.array_equal(runs["dec"][0].numpy(), want)
