"""The port's utils/serialize.py against the JAX package's: a file written
by either loads in the other, both ciphertext layouts included, and both
refuse what does not match (the rejections of tests/test_cli.py).
"""

import numpy as np
import pytest
import torch

from ntt_cuda_tpu.params import get_bfv_params as jget
from ntt_cuda_tpu.utils import serialize as jser
from ntt_cuda_tpu_torch import convert, get_bfv_params
from ntt_cuda_tpu_torch.utils import serialize


P = get_bfv_params("4k_3q")


def _rand(rng, shape):
    return rng.integers(0, 1 << 62, shape, dtype=np.uint64)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_keys_and_ciphertexts_interchange(tmp_path, writer):
    rng = np.random.default_rng(1)
    sk, pk = _rand(rng, (P.r, P.n)), _rand(rng, (2, P.r, P.n))
    ct = _rand(rng, (2, P.r - 1, P.n))
    rlk = _rand(rng, (2, P.r - 1, P.r, P.n))
    gks = {3: _rand(rng, (2, P.r - 1, P.r, P.n)),
           2 * P.n - 1: _rand(rng, (2, P.r - 1, P.r, P.n))}
    save, load = (serialize, jser) if writer == "port" else (jser, serialize)
    jp = jget("4k_3q")
    wp, lp = (P, jp) if writer == "port" else (jp, P)
    t = ((lambda a: convert.to_torch(a, device="cpu")) if writer == "port"
         else (lambda a: a))
    save.save_keypair(tmp_path / "k.npz", wp, t(sk), t(pk))
    save.save_ciphertext(tmp_path / "c.npz", wp, t(ct))
    save.save_relin_keys(tmp_path / "r.npz", wp, t(rlk))
    save.save_galois_keys(tmp_path / "g.npz", wp,
                          {g: t(k) for g, k in gks.items()})
    got_sk, got_pk = load.load_keypair(tmp_path / "k.npz", lp)
    assert got_sk.dtype == np.uint64
    np.testing.assert_array_equal(got_sk, sk)
    np.testing.assert_array_equal(got_pk, pk)
    np.testing.assert_array_equal(load.load_ciphertext(tmp_path / "c.npz", lp),
                                  ct)
    padded = load.load_ciphertext(tmp_path / "c.npz", lp, layout="padded")
    assert padded.shape == (2, P.r, P.n) and not padded[:, -1].any()
    np.testing.assert_array_equal(load.load_relin_keys(tmp_path / "r.npz", lp),
                                  rlk)
    got_g = load.load_galois_keys(tmp_path / "g.npz", lp)
    assert sorted(got_g) == sorted(gks)
    for g in gks:
        np.testing.assert_array_equal(got_g[g], gks[g])


def test_padded_layout_interchanges(tmp_path):
    rng = np.random.default_rng(2)
    ct = _rand(rng, (2, P.r - 1, P.n))
    padded = serialize.pad_ciphertext(convert.to_torch(ct, device="cpu"), P)
    np.testing.assert_array_equal(padded, jser.pad_ciphertext(ct, jget("4k_3q")))
    np.testing.assert_array_equal(serialize.drop_padding(padded), ct)
    jser.save_ciphertext(tmp_path / "p.npz", jget("4k_3q"), padded)
    np.testing.assert_array_equal(
        serialize.load_ciphertext(tmp_path / "p.npz", P, layout="dropped"), ct)
    np.testing.assert_array_equal(
        serialize.load_ciphertext(tmp_path / "p.npz", P), padded)
    assert serialize.FORMAT_VERSION == jser.FORMAT_VERSION


def test_serialize_rejects_mismatches(tmp_path):
    p4 = get_bfv_params("8k_4q")
    path = tmp_path / "keys.npz"
    sk = torch.zeros((P.r, P.n), dtype=torch.int64)
    pk = torch.zeros((2, P.r, P.n), dtype=torch.int64)
    serialize.save_keypair(path, P, sk, pk)
    with pytest.raises(ValueError, match="parameter mismatch"):
        serialize.load_keypair(path, p4)
    with pytest.raises(ValueError, match="parameter mismatch"):
        jser.load_keypair(path, jget("8k_4q"))
    with pytest.raises(ValueError, match="not a ciphertext"):
        serialize.load_ciphertext(path, P)
    with pytest.raises(ValueError, match="not a relin-keys"):
        serialize.load_relin_keys(path, P)
    with pytest.raises(ValueError, match="not a galois-keys"):
        serialize.load_galois_keys(path, P)
    with pytest.raises(ValueError, match="matches neither"):
        serialize.save_ciphertext(tmp_path / "c.npz", P, sk)
    with pytest.raises(ValueError, match="rlk: expected shape"):
        serialize.save_relin_keys(tmp_path / "r.npz", P, pk)
    serialize.save_ciphertext(tmp_path / "c.npz", P,
                              torch.zeros((2, P.r - 1, P.n), dtype=torch.int64))
    with pytest.raises(ValueError, match="unknown layout"):
        serialize.load_ciphertext(tmp_path / "c.npz", P, layout="sideways")
