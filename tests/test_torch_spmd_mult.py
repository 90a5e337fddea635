"""The RNS-sharded EvalMult of the port (ntt_cuda_tpu_torch/parallel/
spmd_mult.py) in real processes, against the JAX package and the port's
single-device context, exactly.

Workers run this file as a script (the `__main__` below, one subprocess a
rank, as tests/test_torch_spmd.py runs its workers), so that they import
the port alone: no jax, no tests/conftest.py.  They start a gloo process
group with a file:// address in the test's temporary directory and write
their results as .npz / .json files.

At R = 2 and R = 4 ranks, n = 2048, r = 4 moduli (rl = 2 and 1; the
JAX package's tests/test_spmd_mult.py set): relin_keygen, mul, mul with
rlk, relinearize, decrypt3, galois_keygen([3], nonce=7) and apply_galois
on the SPMD keygen and encrypt.  Keys and live rows must equal JAX's
`BFVContext.build(params, backend="xla")` and the port's
`BFVContext(device="cpu")`; mul's pad row must be 0; decrypt3 and the
decrypt of the relinearized product must equal the schoolbook negacyclic
product; a JAX rlk carried in by `convert.to_dtensor(key, mesh, 2)` must
relinearize a JAX ct3 to JAX's result; and the collectives must be mul
four all-gathers, relinearize and apply_galois one all-gather and one
all-reduce, decrypt3 one all-reduce, the keygens none.

Both rank counts start first, all ranks together, and the test process
computes the references meanwhile; the workers wait for the JAX ct3 and
rlk they carry in.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
N, BITS, R_MODULI = 2048, 40, 4
RANKS = (2, 4)
SEED = 0x5EED7
GALOIS, GALOIS_NONCE = 3, 7


def _messages(t: int):
    return np.random.default_rng(SEED).integers(0, t, (2, N), dtype=np.int64)


# --- the workers (port only) ------------------------------------------------

def _wait_for(path: Path, timeout: float = 600.0) -> Path:
    end = time.monotonic() + timeout
    while not path.exists():
        if time.monotonic() > end:
            raise TimeoutError(f"{path} never appeared")
        time.sleep(0.1)
    return path


def _pipeline(rank: int, out: Path) -> None:
    import torch
    from ntt_cuda_tpu_torch import convert
    from ntt_cuda_tpu_torch.parallel import mesh, spmd, spmd_mult
    from ntt_cuda_tpu_torch.utils import primegen

    counts = {}

    def counted(name, fn):
        mesh.collectives.clear()
        y = fn()
        counts[name] = [[op, list(shape)] for op, shape in mesh.collectives]
        return y

    p = primegen.make_bfv_params(N, BITS, R_MODULI)
    base = spmd.SpmdBFVContext.build(p, device="cpu")
    ctx = spmd_mult.SpmdMultContext.build(base)
    m1, m2 = (torch.from_numpy(m) for m in _messages(p.t))
    sk, pk = base.keygen()
    ct1 = base.encrypt(pk, m1, nonce=1)
    ct2 = base.encrypt(pk, m2, nonce=2)
    rlk = counted("relin_keygen", lambda: ctx.relin_keygen(sk, nonce=1))
    ct3 = counted("mul", lambda: ctx.mul(ct1, ct2))
    rel = counted("relinearize", lambda: ctx.relinearize(ct3, rlk))
    gks = counted("galois_keygen", lambda: ctx.galois_keygen(
        sk, [GALOIS], nonce=GALOIS_NONCE))
    gal = counted("apply_galois", lambda: ctx.apply_galois(ct1, GALOIS,
                                                           gks[GALOIS]))
    res = {"sk": sk, "ct1": ct1, "ct2": ct2, "rlk": rlk, "ct3": ct3,
           "rel": rel, "mul_rlk": ctx.mul(ct1, ct2, rlk=rlk),
           "gk": gks[GALOIS], "gal": gal,
           "dec3": counted("decrypt3", lambda: ctx.decrypt3(sk, ct3)),
           "dec_rel": base.decrypt(sk, rel), "dec_gal": base.decrypt(sk, gal)}
    ins = np.load(_wait_for(out.parent / "jax_inputs.npz"))
    res["rel_jax_in"] = ctx.relinearize(
        convert.to_dtensor(ins["ct3"], base.mesh, 1),
        convert.to_dtensor(ins["rlk"], base.mesh, 2))
    arrays = {k: convert.from_dtensor(v) for k, v in res.items()}
    if rank == 0:
        np.savez(out / "pipeline.npz", **arrays)
        (out / "counts.json").write_text(json.dumps(counts))


def _worker(R: int, rank: int, out: Path) -> None:
    import torch
    torch.set_num_threads(1)
    from ntt_cuda_tpu_torch.parallel import multihost
    multihost.initialize(f"file://{out / 'init'}", R, rank, backend="gloo")
    try:
        _pipeline(rank, out)
        assert "jax" not in sys.modules, "a worker imported jax"
    finally:
        import torch.distributed as dist
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    _worker(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
    sys.exit(0)

import pytest  # noqa: E402


# --- the test process ---------------------------------------------------------

def _start(R: int, out: Path) -> list:
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    return [subprocess.Popen(
        [sys.executable, __file__, str(R), str(rank), str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=str(ROOT)) for rank in range(R)]


def _finish(procs: dict) -> None:
    """Wait for every worker; raise with the output of any that failed."""
    outs = {}
    try:
        for key, proc in procs.items():
            outs[key] = proc.communicate(timeout=600)[0]
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for (R, rank), proc in procs.items():
        assert proc.returncode == 0, (f"worker {rank}/{R} failed:\n"
                                      f"{outs[(R, rank)]}")


def _references(d: Path) -> tuple[dict, dict]:
    """The port's single-device context and JAX's xla pipeline on the same
    inputs (JAX takes the port's sk and ciphertexts, equal to its own);
    writes the JAX ct3 (padded) and rlk for the workers."""
    import jax.numpy as jnp
    from ntt_cuda_tpu.models import bfv as jbfv
    from ntt_cuda_tpu.utils import golden
    from ntt_cuda_tpu.utils import primegen as jprimegen
    from ntt_cuda_tpu_torch import convert
    from ntt_cuda_tpu_torch.models import bfv

    jp = jprimegen.make_bfv_params(N, BITS, R_MODULI)
    ctx = bfv.BFVContext.build(convert.params_from(jp), device="cpu")
    m1, m2 = _messages(jp.t)
    sk, pk = ctx.keygen()
    ct1, ct2 = ctx.encrypt(pk, m1, nonce=1), ctx.encrypt(pk, m2, nonce=2)
    rlk = ctx.relin_keygen(sk, nonce=1)
    ct3 = ctx.mul(ct1, ct2)
    gk = ctx.galois_keygen(sk, [GALOIS], nonce=GALOIS_NONCE)[GALOIS]
    port = {"sk": sk, "ct1": ct1, "ct2": ct2, "rlk": rlk, "ct3": ct3,
            "rel": ctx.relinearize(ct3, rlk), "gk": gk,
            "gal": ctx.apply_galois(ct1, GALOIS, gk)}
    port["dec_gal"] = ctx.decrypt(sk, port["gal"])
    port = {k: convert.to_numpy(v) for k, v in port.items()}

    ref = jbfv.BFVContext.build(jp, backend="xla")
    jsk, jct1, jct2 = (jnp.asarray(port[k]) for k in ("sk", "ct1", "ct2"))
    jrlk = ref.relin_keygen(jsk, nonce=1)
    jct3 = ref.mul(jct1, jct2)
    jgk = ref.galois_keygen(jsk, [GALOIS], nonce=GALOIS_NONCE)[GALOIS]
    jax_ = {"rlk": jrlk, "ct3": jct3, "rel": ref.relinearize(jct3, jrlk),
            "gk": jgk, "gal": ref.apply_galois(jct1, GALOIS, jgk),
            "dec3": ref.decrypt(jsk, jct3)}
    jax_ = {k: np.asarray(v).astype(np.uint64) for k, v in jax_.items()}
    jax_["product"] = np.array(golden.schoolbook_negacyclic(
        m1.tolist(), m2.tolist(), jp.t, N), dtype=np.uint64)
    padded = np.concatenate([jax_["ct3"], np.zeros((3, 1, N), np.uint64)],
                            axis=1)
    np.savez(d / "jax_inputs.tmp.npz", ct3=padded, rlk=jax_["rlk"])
    os.replace(d / "jax_inputs.tmp.npz", d / "jax_inputs.npz")
    return jax_, port


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """({R: (the workers' arrays, collectives per op)}, JAX's results, the
    port's single-device results).  The references run on one torch
    thread, as the workers do: the suite runs in several worker processes
    at once."""
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield _run_all(tmp_path_factory.mktemp("spmd_mult"))
    finally:
        torch.set_num_threads(threads)


def _run_all(d: Path):
    procs = {}
    for R in RANKS:
        (d / f"R{R}").mkdir()
        procs.update({(R, rank): proc for rank, proc in
                      enumerate(_start(R, d / f"R{R}"))})
    try:
        jax_, port = _references(d)
    except BaseException:
        for proc in procs.values():       # they would wait for the inputs
            proc.kill()
            proc.communicate()
        raise
    _finish(procs)
    got = {R: (dict(np.load(d / f"R{R}" / "pipeline.npz")),
               json.loads((d / f"R{R}" / "counts.json").read_text()))
           for R in RANKS}
    return got, jax_, port


def _live(ct):
    return ct[:, :R_MODULI - 1]


@pytest.mark.parametrize("R", RANKS)
def test_spmd_switching_keys_equal_jax_and_port(runs, R):
    got, jax_, port = runs
    arrays = got[R][0]
    for k in ("rlk", "gk"):
        assert arrays[k].shape == (2, R_MODULI - 1, R_MODULI, N)
        np.testing.assert_array_equal(arrays[k], jax_[k], err_msg=k)
        np.testing.assert_array_equal(arrays[k], port[k], err_msg=k)


@pytest.mark.parametrize("R", RANKS)
def test_spmd_mul_equals_jax_and_port(runs, R):
    """The padded (3, r, n) product: live rows equal, the pad row 0; the
    SPMD inputs' live rows equal the single-device ones."""
    got, jax_, port = runs
    arrays = got[R][0]
    np.testing.assert_array_equal(arrays["sk"], port["sk"])
    for k in ("ct1", "ct2"):
        np.testing.assert_array_equal(_live(arrays[k]), port[k], err_msg=k)
    assert arrays["ct3"].shape == (3, R_MODULI, N)
    np.testing.assert_array_equal(_live(arrays["ct3"]), jax_["ct3"])
    np.testing.assert_array_equal(_live(arrays["ct3"]), port["ct3"])
    assert not arrays["ct3"][:, R_MODULI - 1].any()


@pytest.mark.parametrize("R", RANKS)
def test_spmd_relinearize_and_galois_equal_jax_and_port(runs, R):
    """relinearize, mul with rlk and apply_galois on live rows; the
    relinearized pad row stays 0."""
    got, jax_, port = runs
    arrays = got[R][0]
    for k, want in (("rel", "rel"), ("mul_rlk", "rel"), ("gal", "gal")):
        assert arrays[k].shape == (2, R_MODULI, N)
        np.testing.assert_array_equal(_live(arrays[k]), jax_[want],
                                      err_msg=k)
        np.testing.assert_array_equal(_live(arrays[k]), port[want],
                                      err_msg=k)
    assert not arrays["rel"][:, R_MODULI - 1].any()


@pytest.mark.parametrize("R", RANKS)
def test_spmd_products_decrypt_to_the_schoolbook_product(runs, R):
    """decrypt3 and the relinearized decrypt equal the schoolbook
    negacyclic m1 m2 mod t (and JAX's L = 3 decrypt); the Galois result
    decrypts as the single-device one."""
    got, jax_, port = runs
    arrays = got[R][0]
    np.testing.assert_array_equal(jax_["dec3"], jax_["product"])
    for k in ("dec3", "dec_rel"):
        np.testing.assert_array_equal(arrays[k], jax_["product"], err_msg=k)
    np.testing.assert_array_equal(arrays["dec_gal"], port["dec_gal"])


@pytest.mark.parametrize("R", RANKS)
def test_spmd_relinearizes_jax_keys_and_ciphertexts(runs, R):
    """A JAX rlk and a JAX ct3, carried in by convert.to_dtensor (the rlk
    over axis 2), relinearize to JAX's result on live rows."""
    got, jax_, _ = runs
    np.testing.assert_array_equal(_live(got[R][0]["rel_jax_in"]),
                                  jax_["rel"])


@pytest.mark.parametrize("R", RANKS)
def test_spmd_mult_collective_counts(runs, R):
    """The counterpart of tests/test_spmd_mult.py's HLO count: mul four
    all-gathers ((2, r, n) twice, (3, r, n) twice), relinearize and
    apply_galois one (r, n) all-gather and one (2, n) all-reduce, decrypt3
    one (3, n) all-reduce, relin_keygen and galois_keygen none."""
    r = R_MODULI
    switch = [["all_gather", [r, N]], ["all_reduce", [2, N]]]
    assert runs[0][R][1] == {
        "relin_keygen": [], "galois_keygen": [],
        "mul": ([["all_gather", [2, r, N]]] * 2
                + [["all_gather", [3, r, N]]] * 2),
        "relinearize": switch, "apply_galois": switch,
        "decrypt3": [["all_reduce", [3, N]]]}
