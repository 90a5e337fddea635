"""The 2-D EvalMult of the port (ntt_cuda_tpu_torch/parallel/
spmd2d_mult.py) in real processes, against the JAX package and the port's
single-device context, exactly (tolerance 0).

Workers run this file as a script (the `__main__` below, one subprocess a
rank, as tests/test_torch_spmd2d.py runs its workers), so that they import
the port alone.  They start a gloo process group with a file:// address
in the test's temporary directory and write their results as .npz / .json
files.

At meshes (rns, coef) = (1, 2) and (2, 2), n = 1024, r = 4 moduli of 28
bits (the JAX package's tests/test_spmd2d_mult.py set), both meshes'
workers and two JAX processes started together while the test process
computes the port's references (JAX runs on the port's sk and
ciphertexts, equal to its own): on the 2-D keygen and encrypt of two messages, relin_keygen, mul, mul with
rlk, relinearize, galois_keygen at g = 3 and 2n - 1 (the column swap,
the last Galois stream region), apply_galois at both and decrypt3.  Keys
and live rows must equal JAX's `BFVContext.build(params, backend="xla")`
and the port's `BFVContext(device="cpu")`; mul's pad row must be 0;
decrypt3 and the decrypt of the relinearized product must equal the
schoolbook negacyclic product; and the collectives must be the JAX
package's budget: a relinearized mul four all-gathers over 'rns' and the
key switch's one more and one all-reduce, apply_galois one more
all-gather over 'coef', every transform log2 C ppermutes.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
N, BITS, R_MODULI = 1024, 28, 4
MESHES = ((1, 2), (2, 2))
SEED = 0x2D3D
GALOIS = (3, 2 * N - 1)
GALOIS_NONCE = 7


def _messages(t: int):
    return np.random.default_rng(SEED).integers(0, t, (2, N), dtype=np.int64)


def _jax_reference(half: str, d: Path) -> None:
    """JAX's xla pipeline on the port's sk and ciphertexts (equal to its
    own), one half to d/jax_<half>.npz: "mult" relin_keygen, mul,
    relinearize and the decrypt of the product, "galois" the Galois keys
    and rotations (this file run as `--jax half d`, both halves at once,
    on the CPU as tests/conftest.py runs JAX)."""
    import time

    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from ntt_cuda_tpu.models import bfv as jbfv
    from ntt_cuda_tpu.utils import golden
    from ntt_cuda_tpu.utils import primegen as jprimegen

    jp = jprimegen.make_bfv_params(N, BITS, R_MODULI)
    ref = jbfv.BFVContext.build(jp, backend="xla")
    path = d / "port_inputs.npz"
    end = time.monotonic() + 300
    while not path.exists():
        if time.monotonic() > end:
            raise TimeoutError(f"{path} never appeared")
        time.sleep(0.1)
    ins = np.load(path)
    jsk, jct1, jct2 = (jnp.asarray(ins[k]) for k in ("sk", "ct1", "ct2"))
    if half == "mult":
        m1, m2 = _messages(jp.t)
        jrlk = ref.relin_keygen(jsk, nonce=1)
        jct3 = ref.mul(jct1, jct2)
        res = {"rlk": jrlk, "ct3": jct3, "rel": ref.relinearize(jct3, jrlk),
               "dec3": ref.decrypt(jsk, jct3),
               "product": np.array(golden.schoolbook_negacyclic(
                   m1.tolist(), m2.tolist(), jp.t, N))}
    else:
        jgks = ref.galois_keygen(jsk, GALOIS, nonce=GALOIS_NONCE)
        res = {}
        for g in GALOIS:
            res[f"gk_{g}"] = jgks[g]
            res[f"gal_{g}"] = ref.apply_galois(jct1, g, jgks[g])
            res[f"tau_{g}"] = ref.decrypt(jsk, res[f"gal_{g}"])
    np.savez(d / f"jax_{half}.npz",
             **{k: np.asarray(v).astype(np.uint64) for k, v in res.items()})


# --- the workers (port only) ------------------------------------------------

def _pipeline(R: int, C: int, rank: int, out: Path) -> None:
    import torch
    from ntt_cuda_tpu_torch import convert
    from ntt_cuda_tpu_torch.parallel import mesh, multihost, spmd2d, spmd2d_mult
    from ntt_cuda_tpu_torch.utils import primegen

    counts = {}

    def counted(name, fn):
        mesh.collectives.clear()
        y = fn()
        counts[name] = [[op, list(shape)] for op, shape in mesh.collectives]
        return y

    p = primegen.make_bfv_params(N, BITS, R_MODULI)
    base = spmd2d.Spmd2DBFVContext.build(
        p, mesh=multihost.pod_mesh(R, C, device_type="cpu"), device="cpu")
    ctx = spmd2d_mult.Spmd2DMultContext.build(base)
    m1, m2 = (torch.from_numpy(m) for m in _messages(p.t))
    sk, pk = base.keygen()
    ct1 = base.encrypt(pk, m1, nonce=1)
    ct2 = base.encrypt(pk, m2, nonce=2)
    rlk = counted("relin_keygen", lambda: ctx.relin_keygen(sk, nonce=1))
    ct3 = counted("mul", lambda: ctx.mul(ct1, ct2))
    rel = counted("relinearize", lambda: ctx.relinearize(ct3, rlk))
    mul_rlk = counted("mul_rlk", lambda: ctx.mul(ct1, ct2, rlk=rlk))
    gks = counted("galois_keygen", lambda: ctx.galois_keygen(
        sk, GALOIS, nonce=GALOIS_NONCE))
    gal = {g: counted(f"apply_galois_{g}", lambda g=g: ctx.apply_galois(
        ct1, g, gks[g])) for g in GALOIS}
    res = {"sk": sk, "ct1": ct1, "ct2": ct2, "rlk": rlk, "ct3": ct3,
           "rel": rel, "mul_rlk": mul_rlk,
           "dec3": counted("decrypt3", lambda: ctx.decrypt3(sk, ct3)),
           "dec_rel": base.decrypt(sk, rel)}
    for g in GALOIS:
        res[f"gk_{g}"], res[f"gal_{g}"] = gks[g], gal[g]
        res[f"dec_gal_{g}"] = base.decrypt(sk, gal[g])
    arrays = {k: convert.from_dtensor(v) for k, v in res.items()}
    if rank == 0:
        np.savez(out / "pipeline.npz", **arrays)
        (out / "counts.json").write_text(json.dumps(counts))


def _worker(R: int, C: int, rank: int, out: Path) -> None:
    import torch
    torch.set_num_threads(1)
    from ntt_cuda_tpu_torch.parallel import multihost
    multihost.initialize(f"file://{out / 'init'}", R * C, rank,
                         backend="gloo")
    try:
        _pipeline(R, C, rank, out)
        assert "jax" not in sys.modules, "a worker imported jax"
    finally:
        import torch.distributed as dist
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    if sys.argv[1] == "--jax":
        _jax_reference(sys.argv[2], Path(sys.argv[3]))
    else:
        _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
                Path(sys.argv[4]))
    sys.exit(0)

import pytest  # noqa: E402


# --- the test process ---------------------------------------------------------

def _start(R: int, C: int, out: Path) -> list:
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    return [subprocess.Popen(
        [sys.executable, __file__, str(R), str(C), str(rank), str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=str(ROOT)) for rank in range(R * C)]


def _finish(procs: dict) -> None:
    """Wait for every worker (killing any left after the timeout); raise
    with the output of any that failed."""
    outs = {}
    try:
        for key, proc in procs.items():
            outs[key] = proc.communicate(timeout=300)[0]
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for key, proc in procs.items():
        assert proc.returncode == 0, f"worker {key} failed:\n{outs[key]}"


def _port_references(d: Path) -> dict:
    """The port's single-device context on the same calls; its sk and
    ciphertexts also to d/port_inputs.npz for the JAX processes."""
    from ntt_cuda_tpu_torch import convert
    from ntt_cuda_tpu_torch.models import bfv
    from ntt_cuda_tpu_torch.utils import primegen

    ctx = bfv.BFVContext.build(primegen.make_bfv_params(N, BITS, R_MODULI),
                               device="cpu")
    m1, m2 = _messages(ctx.params.t)
    sk, pk = ctx.keygen()
    ct1, ct2 = ctx.encrypt(pk, m1, nonce=1), ctx.encrypt(pk, m2, nonce=2)
    ins = {k: convert.to_numpy(v) for k, v in
           (("sk", sk), ("ct1", ct1), ("ct2", ct2))}
    np.savez(d / "port_inputs.tmp.npz", **ins)
    os.replace(d / "port_inputs.tmp.npz", d / "port_inputs.npz")
    rlk = ctx.relin_keygen(sk, nonce=1)
    ct3 = ctx.mul(ct1, ct2)
    gks = ctx.galois_keygen(sk, GALOIS, nonce=GALOIS_NONCE)
    port = {"rlk": rlk, "ct3": ct3, "rel": ctx.relinearize(ct3, rlk)}
    for g in GALOIS:
        port[f"gk_{g}"] = gks[g]
        port[f"gal_{g}"] = ctx.apply_galois(ct1, g, gks[g])
    return {**ins, **{k: convert.to_numpy(v) for k, v in port.items()}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """({(R, C): (the workers' arrays, collectives per op)}, JAX's results,
    the port's single-device results).  Both meshes' workers and the two
    JAX processes run while the test process computes the port's
    references (on one torch thread, as the workers do)."""
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    d = tmp_path_factory.mktemp("spmd2d_mult")
    # XLA's backend optimisation off in the JAX processes (a third less
    # compile time, the same integers), one thread each
    jax_env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=(
        "--xla_backend_optimization_level=0 "
        "--xla_cpu_multi_thread_eigen=false"))
    procs = {f"JAX {half}": subprocess.Popen(
        [sys.executable, __file__, "--jax", half, str(d)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=jax_env, cwd=str(ROOT)) for half in ("mult", "galois")}
    try:
        for R, C in MESHES:
            out = d / f"m{R}x{C}"
            out.mkdir()
            procs.update({f"{R}x{C} rank {rank}": proc for rank, proc in
                          enumerate(_start(R, C, out))})
        port = _port_references(d)
        _finish(procs)
    finally:
        torch.set_num_threads(threads)
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    got = {m: (dict(np.load(d / f"m{m[0]}x{m[1]}" / "pipeline.npz")),
               json.loads((d / f"m{m[0]}x{m[1]}" / "counts.json")
                          .read_text()))
           for m in MESHES}
    jax_ = {k: v for half in ("mult", "galois")
            for k, v in np.load(d / f"jax_{half}.npz").items()}
    return got, jax_, port


def _live(ct):
    return ct[:, :R_MODULI - 1]


MESH_IDS = [f"{R}x{C}" for R, C in MESHES]


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_spmd2d_switching_keys_equal_jax_and_port(runs, mesh):
    """relin_keygen and galois_keygen at g = 3 and 2n - 1, whole."""
    got, jax_, port = runs
    arrays = got[mesh][0]
    np.testing.assert_array_equal(arrays["sk"], port["sk"])
    for k in ["rlk"] + [f"gk_{g}" for g in GALOIS]:
        assert arrays[k].shape == (2, R_MODULI - 1, R_MODULI, N)
        np.testing.assert_array_equal(arrays[k], jax_[k], err_msg=k)
        np.testing.assert_array_equal(arrays[k], port[k], err_msg=k)


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_spmd2d_mul_equals_jax_and_port(runs, mesh):
    """The padded (3, r, n) product: live rows equal, the pad row 0; the
    2-D inputs' live rows equal the single-device ones."""
    got, jax_, port = runs
    arrays = got[mesh][0]
    for k in ("ct1", "ct2"):
        np.testing.assert_array_equal(_live(arrays[k]), port[k], err_msg=k)
    assert arrays["ct3"].shape == (3, R_MODULI, N)
    np.testing.assert_array_equal(_live(arrays["ct3"]), jax_["ct3"])
    np.testing.assert_array_equal(_live(arrays["ct3"]), port["ct3"])
    assert not arrays["ct3"][:, R_MODULI - 1].any()


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_spmd2d_relinearize_and_galois_equal_jax_and_port(runs, mesh):
    """relinearize, mul with rlk and apply_galois at both elements on live
    rows; the relinearized pad row stays 0."""
    got, jax_, port = runs
    arrays = got[mesh][0]
    for k, ref in [("rel", "rel"), ("mul_rlk", "rel")] + [
            (f"gal_{g}", f"gal_{g}") for g in GALOIS]:
        assert arrays[k].shape == (2, R_MODULI, N)
        np.testing.assert_array_equal(_live(arrays[k]), jax_[ref], err_msg=k)
        np.testing.assert_array_equal(_live(arrays[k]), port[ref], err_msg=k)
    assert not arrays["rel"][:, R_MODULI - 1].any()


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_spmd2d_decrypts_equal_schoolbook(runs, mesh):
    """decrypt3 and the relinearized decrypt equal the schoolbook
    negacyclic m1 m2 mod t (and JAX's decrypt of its own product); the
    rotations decrypt as JAX's do."""
    got, jax_, _ = runs
    arrays = got[mesh][0]
    np.testing.assert_array_equal(jax_["dec3"], jax_["product"])
    for k in ("dec3", "dec_rel"):
        np.testing.assert_array_equal(arrays[k], jax_["product"], err_msg=k)
    for g in GALOIS:
        np.testing.assert_array_equal(arrays[f"dec_gal_{g}"],
                                      jax_[f"tau_{g}"], err_msg=str(g))


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_spmd2d_mult_collectives_are_jax_budget(runs, mesh):
    """The JAX package's budget (spmd2d_mult.py's docstring): a mul four
    all-gathers over 'rns' and, with rlk, the key switch's one more and one
    all-reduce over 'rns'; apply_galois one more all-gather, over 'coef';
    every transform log2 C ppermutes over 'coef' (a batch of polynomials
    one transform): mul's two forwards and two tensor inverses, the key
    switch's forward and inverse, the keys' inverse and forward, tau_g(s)'s
    inverse and forward, decrypt3's forward and inverse."""
    got, _, _ = runs
    counts = got[mesh][1]
    R, C = mesh
    r, k, rl, S = R_MODULI, R_MODULI - 1, R_MODULI // R, N // C
    logc = C.bit_length() - 1
    E = len(GALOIS)

    def pp(*shape):
        return [["ppermute", list(shape)]] * logc

    tensor = pp(4, rl, S) + pp(3, rl, S)
    mul = ([["all_gather", [2, r, S]]] * 2 + tensor + tensor
           + [["all_gather", [3, r, S]]] * 2)
    switch = ([["all_gather", [r, S]]] + pp(k, rl, S) + pp(2, rl, S)
              + [["all_reduce", [2, S]]])
    gal = [["all_gather", [2, rl, N]]] + switch
    assert counts == {
        "relin_keygen": pp(k, rl, S) * 2,
        "mul": mul, "relinearize": switch, "mul_rlk": mul + switch,
        "galois_keygen": (pp(rl, S) + [["all_gather", [rl, N]]]
                          + pp(E, rl, S) + pp(E * k, rl, S) * 2),
        **{f"apply_galois_{g}": gal for g in GALOIS},
        "decrypt3": pp(2, rl, S) + pp(rl, S) + [["all_reduce", [3, S]]]}
