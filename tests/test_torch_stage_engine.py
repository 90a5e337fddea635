"""The stage engine of csrc/ntt_stage.cu (the wide launches' persistent,
modulus-grouped form: G clusters of 8 walk the polynomials by modulus,
each block's twiddles in shared memory) against the plain versions,
exactly, and the count of its launches in utils/tracing.py.

* Here, on the CPU: the host build of csrc/ (`cuda.host_library`), whose
  engine entry points (`ntt_stage_{forward,inverse}_engine`) walk the G
  clusters' work lists one block thread at a time: every prologue and the +e
  epilogue at 2^14, 2^15 and 2^16, at G from one cluster to more clusters
  than polynomials (r above G, lists that split unevenly, an empty
  cluster), one polynomial alone, and coefficient shards (logc > 0).
  mod_idx is refused: kernel 12 stays on the kernel of OCC = 1.
* On the card (`-m gpu`): the launchers' rule at each server cell's
  launch widths takes the engine, and its outputs equal the plain
  versions.
"""

import functools

import numpy as np
import pytest
import torch

from ntt_cuda_tpu_torch import cuda, get_bfv_params
from ntt_cuda_tpu_torch.models.bfv import BFVContext
from ntt_cuda_tpu_torch.ops import fused_ops, modmath, ntt, poly, sampling
from ntt_cuda_tpu_torch.parallel import coef_kernels, sharded
from ntt_cuda_tpu_torch.utils import primegen, tracing



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in
    several worker processes at once."""
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


@functools.cache
def _tables(logn: int, r: int) -> ntt.NTTTables:
    p = primegen.make_bfv_params(1 << logn, 55, r)
    return ntt.NTTTables.build(p.q, p.psi, p.n, device="cpu")


def _rand_res(rng, tb, lead=(), n=None):
    qs = [int(q) for q in tb.ms.q.flatten()]
    return torch.from_numpy(np.stack(
        [rng.integers(0, q, lead + (n or tb.n,)) for q in qs], axis=-2))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _engine(lib, inverse, out, tb, pro, G, x=None, d=None, y=None, e=None,
            nu=None, ny=1, logc=0, shard=0, mod_idx=None, rule=False):
    """One host launch on the engine over G clusters (0: one a polynomial),
    or through the launchers' rule; its return code."""
    n = out.shape[-1]
    P, logn = out.numel() // n, n.bit_length() - 1
    if inverse:
        args = (_ptr(x), _ptr(y), _ptr(e), out.data_ptr(), *tb.kernel_args(),
                pro, ny, P, tb.r, logn, _ptr(mod_idx), logc, shard)
    else:
        args = (_ptr(x), _ptr(d), _ptr(y), _ptr(nu), out.data_ptr(),
                *tb.kernel_args(), pro, P, tb.r, logn, _ptr(mod_idx), logc,
                shard)
    way = "inverse" if inverse else "forward"
    if rule:
        return getattr(lib, f"ntt_stage_{way}_cluster")(*args, 0, None)
    return getattr(lib, f"ntt_stage_{way}_engine")(*args, G, None)


def _case(pro: str, tb, rng, J: int):
    """(inverse, launch arguments, plain result) of prologue `pro` over J
    messages of tb's r moduli."""
    ms, n, r = tb.ms, tb.n, tb.r
    x = _rand_res(rng, tb, (J,))
    x[:, :, 0] = ms.q.flatten() - 1                     # x + e == q
    d = torch.from_numpy(rng.integers(-19, 17, (J, n)).astype(np.int32))
    t = d.clamp(-1, 2)
    if pro == "copy":
        return False, dict(pro=cuda.PRO_COPY, x=x), ntt.ntt_forward(x, tb)
    if pro == "ternary":
        return (False, dict(pro=cuda.PRO_TERNARY, d=t),
                ntt.ntt_forward(sampling.small_res(t, ms.q), tb))
    if pro == "addneg_gauss":
        return (False, dict(pro=cuda.PRO_ADDNEG_GAUSS, x=x, d=d),
                ntt.ntt_forward(poly.poly_add_negate(
                    x, sampling.small_res(d, ms.q), ms), tb))
    if pro == "addneg":
        e = _rand_res(rng, tb, (J,))
        e[:, :, 0] = 1
        return (False, dict(pro=cuda.PRO_ADDNEG, x=x, y=e),
                ntt.ntt_forward(poly.poly_add_negate(x, e, ms), tb))
    if pro == "digit":
        c2 = torch.from_numpy(rng.integers(0, int(ms.q.max()), (J, n)))
        return (False, dict(pro=cuda.PRO_DIGIT, x=c2, nu=ms.nu),
                ntt.ntt_forward(modmath.mod_u64(c2[:, None, :], ms.q, ms.nu),
                                tb))
    if pro == "mont":                                   # y shared by J
        y = _rand_res(rng, tb)
        return (True, dict(pro=cuda.PRO_MONT, x=x, y=y, ny=r),
                ntt.ntt_inverse(ntt.dyadic_mul(x, y, ms), tb))
    if pro == "mont_e":                                 # kernel 13's +e
        u = _rand_res(rng, tb)
        return (True, dict(pro=cuda.PRO_MONT, x=x, y=u, e=d, ny=r),
                poly.poly_add(ntt.ntt_inverse(ntt.dyadic_mul(x, u, ms), tb),
                              sampling.small_res(d, ms.q), ms))
    assert pro == "ksacc"
    k = 2
    c2 = torch.from_numpy(rng.integers(0, int(ms.q.max()), (J // 2, k, n)))
    ksk = _rand_res(rng, tb, (2, k))
    dhat = ntt.ntt_forward(modmath.mod_u64(c2[..., None, :], ms.q, ms.nu), tb)
    return (True, dict(pro=cuda.PRO_KSACC, x=dhat, y=ksk, ny=k),
            fused_ops.keyswitch_front_plain(c2, ksk, tb).reshape(J, r, n))


PROS = ("copy", "ternary", "addneg_gauss", "addneg", "digit", "mont",
        "mont_e", "ksacc")


@pytest.mark.parametrize("pro", PROS)
@pytest.mark.parametrize("logn", [14, 15, 16])
def test_host_engine_matches_plain(host_lib, logn, pro):
    """Every prologue (and the +e epilogue) over J = 4 messages of three
    moduli, P = 12 polynomials, 4 a modulus: on G = 1 and 2 clusters (r
    above G), 5 (lists of 2 and 3; the moduli split 2 + 2, 3 + 1, 1 + 3)
    and 13 (one a cluster, one cluster empty), and through the host's rule
    (the kernel of OCC = 1), all equal to the plain version."""
    tb = _tables(logn, 3)
    rng = np.random.default_rng(logn * 10 + PROS.index(pro))
    inverse, kw, ref = _case(pro, tb, rng, 4)
    for G in (1, 2, 5, 13, None):
        out = torch.full_like(ref, -1)
        assert _engine(host_lib, inverse, out, tb, G=G or 0, rule=G is None,
                       **kw) == 0, G
        assert torch.equal(out, ref), G


def test_host_engine_one_polynomial(host_lib):
    """One polynomial alone (r = 1, P = 1) on one cluster and on two (one
    empty), both ways."""
    tb = _tables(15, 1)
    x = _rand_res(np.random.default_rng(7), tb)
    for inverse, ref in ((False, ntt.ntt_forward(x, tb)),
                         (True, ntt.ntt_inverse(x, tb))):
        for G in (1, 2):
            out = torch.empty_like(x)
            assert _engine(host_lib, inverse, out, tb, cuda.PRO_COPY, G,
                           x=x) == 0
            assert torch.equal(out, ref)


@pytest.mark.parametrize("C", [2, 4])
def test_host_engine_shards(host_lib, C):
    """Coefficient shard c of C (logc > 0, the twiddle base C + c) at 2^15:
    the forward's local stages, the inverse with y and PRO_KSACC's (the
    2-D key switch's accumulate) on G = 2 and 5 clusters, every shard."""
    tb = _tables(15, 3)
    logc, S, k = C.bit_length() - 1, tb.n // C, 2
    rng = np.random.default_rng(C)
    x, y = _rand_res(rng, tb, (2,), S), _rand_res(rng, tb, (2,), S)
    dk, kk = _rand_res(rng, tb, (k,), S), _rand_res(rng, tb, (2, k), S)
    for c in range(C):
        cases = (
            (False, dict(pro=cuda.PRO_COPY, x=x),
             sharded.local_forward_stages(x, tb, C, c)),
            (True, dict(pro=cuda.PRO_MONT, x=x, y=y, ny=2 * tb.r),
             coef_kernels.local_inverse_mul_plain(x, y, tb, C, c)),
            (True, dict(pro=cuda.PRO_KSACC, x=dk, y=kk, ny=k),
             coef_kernels.local_keyswitch_acc_plain(dk, kk, tb, C, c)))
        for inverse, kw, ref in cases:
            for G in (2, 5):
                out = torch.empty_like(ref)
                assert _engine(host_lib, inverse, out, tb, G=G, logc=logc,
                               shard=c, **kw) == 0
                assert torch.equal(out, ref), (c, kw["pro"], G)


def test_host_engine_refuses(host_lib):
    """mod_idx (kernel 12) takes the kernel of OCC = 1 and the engine
    refuses it; a path below -1 is refused."""
    tb = _tables(14, 3)
    x = _rand_res(np.random.default_rng(3), tb, (1,))
    idx = torch.tensor([2, 0, 1], dtype=torch.int32)
    out = torch.empty_like(x)
    for inverse in (False, True):
        assert _engine(host_lib, inverse, out, tb, cuda.PRO_COPY, 2, x=x,
                       mod_idx=idx) != 0
        assert _engine(host_lib, inverse, out, tb, cuda.PRO_COPY, -1, x=x,
                       mod_idx=idx) == 0
        assert _engine(host_lib, inverse, out, tb, cuda.PRO_COPY, -2,
                       x=x) != 0


# --- the count of each path (utils/tracing.py) ------------------------------

def test_stage_paths_count_each_launch(host_lib, monkeypatch):
    """tracing.stage_paths(): the loaded library's stage launches since the
    last reset(), by path; a refused launch counts nothing."""
    monkeypatch.setattr(cuda, "loaded", lambda: host_lib)
    tb = _tables(14, 3)
    x = _rand_res(np.random.default_rng(4), tb, (1,))
    out = torch.empty_like(x)
    tracing.reset()
    assert tracing.stage_paths() == {"engine": 0, "one": 0}
    for G, rule in ((3, False), (0, False), (-1, False), (0, True)):
        assert _engine(host_lib, False, out, tb, cuda.PRO_COPY, G, x=x,
                       rule=rule) == 0
    assert _engine(host_lib, True, out, tb, cuda.PRO_COPY, 2, x=x,
                   mod_idx=torch.zeros(3, dtype=torch.int32)) != 0
    assert tracing.stage_paths() == {"engine": 2, "one": 2}
    tracing.reset()
    assert tracing.stage_paths() == {"engine": 0, "one": 0}


def test_stage_paths_zero_before_the_library_loads(monkeypatch):
    monkeypatch.setattr(cuda, "loaded", lambda: None)
    tracing.reset()
    assert tracing.stage_paths() == {"engine": 0, "one": 0}


# --- on the card ------------------------------------------------------------

# cell: (parameter set, J), the server cells of portbench/
CELLS = {"32k_9q.mulrelin": ("32k_9q", 8),
         "32k_16q.mulrelin": ("32k_16q", 4),
         "16k_5q.mulrelin": ("16k_5q", 16)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.gpu
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cuda_engine_at_cell_widths(cuda_device, cell):
    """One server request's six stage launches at the cell's J through the
    launchers (the product's forwards and inverses over q and Bsk, the key
    switch's two): each takes the engine, and equals its plain version."""
    name, J = CELLS[cell]
    p, dev = get_bfv_params(name), cuda_device
    ctx = BFVContext.build(p, device=dev)
    tq, tf = ctx.tables_drop, ctx.tables_full
    tb = ctx._mult_setup().tables_bsk
    rng = np.random.default_rng(J)
    ms, n, r, k = tf.ms, p.n, p.r, p.r - 1
    fwd = lambda *a, **kw: ntt.ntt_forward(*a, **kw)

    def engine_taken(launch):
        cuda.library()
        tracing.reset()
        launch()
        assert tracing.stage_paths() == {"engine": 1, "one": 0}

    from ntt_cuda_tpu_torch.ops import ntt_stage
    for t in (tq, tb):
        x, y = _rand_res(rng, t, (4 * J,)).to(dev), \
            _rand_res(rng, t, (4 * J,)).to(dev)
        out = torch.empty_like(x)
        engine_taken(lambda: ntt_stage.forward_launch(dev, x, None, out, t,
                                                      cuda.PRO_COPY))
        assert torch.equal(out, fwd(x, t))
        engine_taken(lambda: ntt_stage.inverse_launch(dev, x, y, None, out,
                                                      t))
        assert torch.equal(out, ntt.ntt_inverse(ntt.dyadic_mul(x, y, t.ms),
                                                t))
    c2 = torch.from_numpy(rng.integers(0, max(p.q), (J, k, n))).to(dev)
    ksk = _rand_res(rng, tf, (2, k)).to(dev)
    dhat = torch.empty((J, k, r, n), dtype=torch.int64, device=dev)
    engine_taken(lambda: ntt_stage.forward_launch(
        dev, c2, None, dhat, tf, cuda.PRO_DIGIT, nu=ms.nu))
    assert torch.equal(dhat, fwd(modmath.mod_u64(c2[..., None, :], ms.q,
                                                 ms.nu), tf))
    acc = torch.empty((J, 2, r, n), dtype=torch.int64, device=dev)
    engine_taken(lambda: cuda.launch(
        "ntt_stage_inverse_cluster", dev, dhat.data_ptr(), ksk.data_ptr(),
        None, acc.data_ptr(), *tf.kernel_args(), cuda.PRO_KSACC, k,
        J * 2 * r, r, p.logn, None, 0, 0, 0))
    assert torch.equal(acc, fused_ops.keyswitch_front_plain(c2, ksk, tf))
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_engine_paths(cuda_device):
    """At 2^15, P = 45 over three moduli: the engine over 1, 4, 7 clusters
    and as many as the card holds, the kernel of OCC = 1 and the rule, each
    equal to the plain version both ways; at 2^16 the card refuses the
    engine (its shared memory) and the rule takes the kernel of OCC = 1."""
    dev = cuda_device
    for logn, J, takes in ((15, 15, True), (16, 2, False)):
        p = primegen.make_bfv_params(1 << logn, 55, 3)
        tb = ntt.NTTTables.build(p.q, p.psi, p.n, dev)
        x = _rand_res(np.random.default_rng(logn), tb, (J,)).to(dev)
        for inverse, ref in ((False, ntt.ntt_forward(x, tb)),
                             (True, ntt.ntt_inverse(x, tb))):
            for G in (1, 4, 7, 0, -1):
                out = torch.empty_like(x)
                rc = _engine(cuda.library(), inverse, out, tb,
                             cuda.PRO_COPY, G, x=x)
                if G >= 0 and not takes:
                    assert rc != 0
                    continue
                assert rc == 0
                assert torch.equal(out, ref), (logn, inverse, G)
            out = torch.empty_like(x)
            assert _engine(cuda.library(), inverse, out, tb, cuda.PRO_COPY,
                           0, x=x, rule=True) == 0
            assert torch.equal(out, ref)
    torch.cuda.synchronize()
