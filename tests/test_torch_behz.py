"""The port's BEHZ machinery (ntt_cuda_tpu_torch.ops.behz and the plain
versions of ops/behz_kernels.py) against the JAX package, on the CPU.
Every comparison is exact (tolerance 0).

1. AuxBase and MultConsts equal the JAX package's for every published set,
   and both packages refuse the same out-of-bounds bases.
2. The plain rns_to_bsk / fast_floor / bsk_to_q / scale_and_round equal
   `ntt_cuda_tpu.ops.behz` (XLA) on seeded residues with a (J, C) lead: at
   4k_3q, and with the 32k_9q and 32k_16q constants over n = 1024 (the
   conversions are per coefficient).
3. The same at 4k_3q against the JAX package's Pallas kernels
   (`behz_pallas`) in interpret mode, and the one-launch scale_and_round
   of csrc/behz.cu (the host build, `cuda.host_library`) at every group
   size G
   against `behz_pallas.scale_and_round` in interpret mode.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntt_cuda_tpu.ops import behz as jbehz
from ntt_cuda_tpu.ops import behz_pallas
from ntt_cuda_tpu.params import get_bfv_params as jget
from ntt_cuda_tpu_torch import BFV_SETS, convert, cuda, get_bfv_params
from ntt_cuda_tpu_torch.ops import behz, behz_kernels


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
    np.testing.assert_array_equal(convert.to_numpy(got),
                                  np.asarray(ref).astype(np.uint64))


@pytest.mark.parametrize("name", sorted(BFV_SETS))
def test_aux_base_and_consts_match_jax(name):
    p, jp = get_bfv_params(name), jget(name)
    aux, jaux = behz.AuxBase.build(p), jbehz.AuxBase.build(jp)
    assert dataclasses.astuple(aux) == dataclasses.astuple(jaux)
    mc, jmc = behz.MultConsts.build(p, aux), jbehz.MultConsts.build(jp, jaux)
    assert mc.k == jmc.k == p.r - 1
    for f in dataclasses.fields(jbehz.MultConsts):
        if f.name == "k":
            continue
        got, ref = getattr(mc, f.name), getattr(jmc, f.name)
        if f.name.startswith("ms_"):
            for g in ("q", "qinv_neg", "r2", "nu"):
                _eq(getattr(got, g), getattr(ref, g))
        else:
            assert tuple(got.shape) == tuple(np.shape(ref)), f.name
            _eq(got, ref)


def test_aux_base_validate_bounds():
    """Both packages refuse the same bases with the same messages."""
    p, jp = get_bfv_params("4k_3q"), jget("4k_3q")
    aux = behz.AuxBase.build(p)
    small = (5, 7)                  # B too small for Shenoy-Kumaresan
    for kw, msg in ((dict(b=small), "Shenoy-Kumaresan"),
                    (dict(m_tilde=4), "m_tilde too small")):
        bad = dataclasses.replace(aux, **kw)
        jbad = jbehz.AuxBase(**dataclasses.asdict(bad))
        with pytest.raises(ValueError, match=msg):
            bad.validate(p)
        with pytest.raises(ValueError, match=msg):
            jbad.validate(jp)
    bad = dataclasses.replace(aux, m_sk=3, b=(aux.b[0], 3))
    with pytest.raises(ValueError) as e1:
        bad.validate(p)
    with pytest.raises(ValueError) as e2:
        jbehz.AuxBase(**dataclasses.asdict(bad)).validate(jp)
    assert str(e1.value) == str(e2.value)


def _xm_at_half(xb_col, aux) -> int:
    """The m_sk residue that puts bsk_to_q's alpha exactly at m_sk >> 1
    (the strict-`>` boundary) for the B residues xb_col of one
    coefficient."""
    b_prod, msk = behz.prod(aux.b), aux.m_sk
    cm = sum((int(x) * pow(b_prod // bj % bj, -1, bj) % bj) * (b_prod // bj)
             for x, bj in zip(xb_col, aux.b))
    return (cm - (msk >> 1) * b_prod) % msk


def _residues(rng, qs, lead, n):
    return np.stack([rng.integers(0, q, lead + (n,), dtype=np.uint64)
                     for q in qs], axis=-2)


@pytest.mark.parametrize("name,n", [("4k_3q", 4096), ("32k_9q", 1024),
                                    ("32k_16q", 1024)])
def test_plain_conversions_match_xla(name, n):
    p, jp = get_bfv_params(name), jget(name)
    mb = behz_kernels.MultBanks.build(p)
    jmc = jbehz.MultConsts.build(jp)
    aux = behz.AuxBase.build(p)
    rng = np.random.default_rng(n + p.r)
    lead = (2, 2)                                 # (J, C)
    xq = _residues(rng, p.q[:-1], lead, n)
    xb = _residues(rng, aux.bsk, lead, n)
    xq[..., 0] = np.array(p.q[:-1], dtype=np.uint64) - np.uint64(1)
    xb[..., 0] = np.array(aux.bsk, dtype=np.uint64) - np.uint64(1)
    k = p.r - 1
    xb[0, 0, k, 1] = _xm_at_half(xb[0, 0, :k, 1], aux)   # the strict `>`
    tq, tb = (convert.to_torch(v, device="cpu") for v in (xq, xb))
    jq, jb = jnp.asarray(xq), jnp.asarray(xb)
    _eq(behz_kernels.rns_to_bsk_plain(tq, mb), jbehz.rns_to_bsk(jq, jmc))
    _eq(behz_kernels.fast_floor_plain(tq, tb, mb),
        jbehz.fast_floor(jq, jb, jmc))
    _eq(behz_kernels.bsk_to_q_plain(tb, mb), jbehz.bsk_to_q(jb, jmc))
    _eq(behz_kernels.scale_and_round_plain(tq, tb, mb),
        jbehz.scale_and_round(jq, jb, jmc))
    # the wrappers take the plain versions for CPU tensors
    _eq(behz_kernels.scale_and_round(tq, tb, mb),
        jbehz.scale_and_round(jq, jb, jmc))


def test_plain_conversions_match_pallas_interpret():
    p, jp = get_bfv_params("4k_3q"), jget("4k_3q")
    mb = behz_kernels.MultBanks.build(p)
    mpc = behz_pallas.MultPallasConsts.build(jp)
    aux = behz.AuxBase.build(p)
    rng = np.random.default_rng(7)
    xq = _residues(rng, p.q[:-1], (2,), p.n)
    xb = _residues(rng, aux.bsk, (2,), p.n)
    tq, tb = (convert.to_torch(v, device="cpu") for v in (xq, xb))
    jq, jb = jnp.asarray(xq), jnp.asarray(xb)
    _eq(behz_kernels.rns_to_bsk_plain(tq, mb),
        behz_pallas.rns_to_bsk(jq, mpc, interpret=True))
    _eq(behz_kernels.fast_floor_plain(tq, tb, mb),
        behz_pallas.fast_floor(jq, jb, mpc, interpret=True))
    _eq(behz_kernels.bsk_to_q_plain(tb, mb),
        behz_pallas.bsk_to_q(jb, mpc, interpret=True))


@pytest.fixture(scope="module")
def host_lib():
    """csrc/*.cu built as host C++, once per checkout (cuda.host_library)."""
    try:
        return cuda.host_library()
    except cuda.NoHostCompiler as e:
        pytest.skip(str(e))


def test_host_scale_and_round_matches_pallas_interpret(host_lib):
    """The one-launch scale_and_round (21b's floors kept on chip and
    converted back to q) at every G, against the JAX package's two Pallas
    kernels in interpret mode at 4k_3q, alpha at m_sk / 2 included."""
    p, jp = get_bfv_params("4k_3q"), jget("4k_3q")
    mb = behz_kernels.MultBanks.build(p)
    mpc = behz_pallas.MultPallasConsts.build(jp)
    aux = behz.AuxBase.build(p)
    k = p.r - 1
    rng = np.random.default_rng(11)
    xq = _residues(rng, p.q[:-1], (2,), p.n)
    xb = _residues(rng, aux.bsk, (2,), p.n)
    xb[0, k, 1] = _xm_at_half(xb[0, :k, 1], aux)
    tq, tb = (convert.to_torch(v, device="cpu") for v in (xq, xb))
    ref = behz_pallas.scale_and_round(jnp.asarray(xq), jnp.asarray(xb), mpc,
                                      interpret=True)
    _eq(behz_kernels.scale_and_round_plain(tq, tb, mb), ref)
    for G in (0,) + behz_kernels.GROUPS:
        out = torch.empty_like(tq)
        assert host_lib.ntt_behz(
            behz_kernels.SCALE_AND_ROUND, tq.data_ptr(), tb.data_ptr(),
            out.data_ptr(), *mb.kernel_args(), 2, k, p.n, 0, k, G,
            None) == 0
        _eq(out, ref)


def test_wrappers_check_shapes():
    mb = behz_kernels.MultBanks.build(get_bfv_params("4k_3q"))
    x = convert.to_torch(np.zeros((3, 64), np.uint64), device="cpu")
    with pytest.raises(ValueError, match="expected shape"):
        behz_kernels.rns_to_bsk(x, mb)            # (k+1, n), not (k, n)
    with pytest.raises(ValueError, match="does not match"):
        behz_kernels.fast_floor(x[:2], x[:, :32], mb)
