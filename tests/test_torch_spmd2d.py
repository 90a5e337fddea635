"""The 2-D sharded BFV program of the port (ntt_cuda_tpu_torch/parallel/
spmd2d.py) in real processes, against the JAX package and the port's
single-device context, exactly (tolerance 0).

Workers run this file as a script (the `__main__` below, one subprocess a
rank, as tests/test_torch_spmd.py runs its workers): they import the port
alone, start a gloo process group with a file:// address in the test's
temporary directory, and write their results as .npz / .json files.

At meshes (rns, coef) = (1, 2) and (2, 2), n = 2048, r = 4 moduli, one
spawn of both meshes' workers at once runs every check, one test a mesh:
parallel/sharded.py's
`sharded_ntt_forward` / `sharded_ntt_inverse` and
`CoefShardedNTT.inverse` on each rank's block (equal to the block of the
single-device transform, checked in the worker), keygen, encrypt of two
messages (nonces 0 and 9), decrypt of both, and a decrypt of the JAX
package's own key and ciphertext carried onto the 2-D mesh by
`convert.to_dtensor`.  Keys and live ciphertext rows must equal JAX's
`BFVContext.build(params, backend="xla")` (the contract
tests/test_spmd2d.py holds JAX's own 2-D program to) and the port's
`BFVContext(device="cpu")`; every message must round-trip; the
collectives must be JAX's budget (tests/test_collectives.py): keygen
3 log2 C ppermutes, encrypt and decrypt 2 log2 C ppermutes and one
all-reduce each.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
N, BITS, R_MODULI = 2048, 40, 4
SEED = 0x2D2D


def _messages(t: int):
    return np.random.default_rng(SEED).integers(0, t, (2, N), dtype=np.int64)


# --- the workers (port only) ------------------------------------------------

def _pipeline(R: int, C: int, rank: int, out: Path) -> None:
    import torch
    from ntt_cuda_tpu_torch import convert
    from ntt_cuda_tpu_torch.ops import ntt
    from ntt_cuda_tpu_torch.parallel import mesh, multihost, sharded, spmd2d
    from ntt_cuda_tpu_torch.utils import primegen

    counts = {}

    def counted(name, fn):
        mesh.collectives.clear()
        y = fn()
        counts[name] = [[op, list(shape)] for op, shape in mesh.collectives]
        return y

    p = primegen.make_bfv_params(N, BITS, R_MODULI)
    pod = multihost.pod_mesh(R, C, device_type="cpu")
    ctx = spmd2d.Spmd2DBFVContext.build(p, mesh=pod, device="cpu")
    # sharded.py's transforms over the mesh, on the rank's block of x
    x = torch.from_numpy(np.stack([
        np.random.default_rng(SEED + i).integers(0, q, N, dtype=np.int64)
        for i, q in enumerate(p.q)]))
    blk = (slice(ctx.lo, ctx.hi), slice(ctx.coef_index * ctx.S,
                                        (ctx.coef_index + 1) * ctx.S))
    tb = ctx.cnt.tables
    fwd = sharded.sharded_ntt_forward(pod, N)(x[blk].contiguous(), tb)
    inv = sharded.sharded_ntt_inverse(pod, N)(x[blk].contiguous(), tb)
    inv_k = ctx.cnt.inverse(x[blk].contiguous(), ctx._exchange())
    try:   # a one-way pair is not an exchange: refused on every rank
        mesh.ppermute(x[blk], [(0, 1)], pod.get_group(mesh.COEF_AXIS))
    except ValueError:
        pass
    else:
        raise AssertionError(f"rank {rank}: ppermute took a one-way pair")
    m1, m2 = (torch.from_numpy(m) for m in _messages(p.t))
    sk, pk = counted("keygen", ctx.keygen)
    ct_a = counted("encrypt", lambda: ctx.encrypt(pk, m1))
    ct_b = ctx.encrypt(pk, m2, nonce=9)
    ins = np.load(out.parent / "jax_inputs.npz")
    res = {"sk": sk, "pk": pk, "ct_a": ct_a, "ct_b": ct_b,
           "dec_a": counted("decrypt", lambda: ctx.decrypt(sk, ct_a)),
           "dec_b": ctx.decrypt(sk, ct_b),
           "dec_jax_in": ctx.decrypt(
               convert.to_dtensor(ins["sk"], pod, 0, 1),
               convert.to_dtensor(ins["ct_padded"], pod, 1, 2))}
    arrays = {k: convert.from_dtensor(v) for k, v in res.items()}
    full = ntt.tables_for(p, device="cpu")
    ref_inv = ntt.ntt_inverse(x, full)[blk]
    if not (torch.equal(fwd, ntt.ntt_forward(x, full)[blk]) and
            torch.equal(inv, ref_inv) and torch.equal(inv_k, ref_inv)):
        raise AssertionError(f"rank {rank}: sharded_ntt_forward / inverse "
                             f"or CoefShardedNTT.inverse != the "
                             f"single-device transform's block")
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


def _spawn(meshes, d: Path) -> None:
    """The R * C workers of every (R, C) mesh, all started together, each
    mesh in its own directory under d; raises with the output of any that
    fails."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    jobs = []
    for R, C in meshes:
        out = d / f"m{R}x{C}"
        out.mkdir()
        jobs += [(f"{R}x{C} rank {rank}", subprocess.Popen(
            [sys.executable, __file__, str(R), str(C), str(rank), str(out)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=str(ROOT))) for rank in range(R * C)]
    outs = []
    try:
        for _, p in jobs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for _, p in jobs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for (name, p), o in zip(jobs, outs):
        assert p.returncode == 0, f"worker {name} failed:\n{o}"


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
            Path(sys.argv[4]))
    sys.exit(0)

import pytest  # noqa: E402


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """The JAX package's single-chip xla pipeline on the same inputs, and
    its key and (padded) ciphertext for the workers to carry in."""
    import jax.numpy as jnp
    from ntt_cuda_tpu.models import bfv
    from ntt_cuda_tpu.utils import primegen

    ref = bfv.BFVContext.build(primegen.make_bfv_params(N, BITS, R_MODULI),
                               backend="xla")
    m1, m2 = (jnp.asarray(m.astype(np.uint64))
              for m in _messages(ref.params.t))
    sk, pk = ref.keygen()
    res = {"sk": sk, "pk": pk, "ct_a": ref.encrypt(pk, m1),
           "ct_b": ref.encrypt(pk, m2, nonce=9)}
    res = {k: np.asarray(v).astype(np.uint64) for k, v in res.items()}
    d = tmp_path_factory.mktemp("spmd2d_jax")
    padded = np.concatenate([res["ct_a"], np.zeros((2, 1, N), np.uint64)],
                            axis=1)
    np.savez(d / "jax_inputs.npz", sk=res["sk"], ct_padded=padded)
    return d, res


@pytest.fixture(scope="module")
def port_ref():
    """The port's single-device context on the CPU, the same calls."""
    from ntt_cuda_tpu_torch import convert
    from ntt_cuda_tpu_torch.models import bfv
    from ntt_cuda_tpu_torch.utils import primegen

    ctx = bfv.BFVContext.build(primegen.make_bfv_params(N, BITS, R_MODULI),
                               device="cpu")
    m1, m2 = _messages(ctx.params.t)
    sk, pk = ctx.keygen()
    res = {"sk": sk, "pk": pk, "ct_a": ctx.encrypt(pk, m1),
           "ct_b": ctx.encrypt(pk, m2, nonce=9)}
    return {k: convert.to_numpy(v) for k, v in res.items()}


MESHES = ((1, 2), (2, 2))


@pytest.fixture(scope="module")
def runs(jax_ref):
    """The workers' outputs and collective log on each (R, C) mesh, both
    meshes' workers run at once."""
    d = jax_ref[0]
    _spawn(MESHES, d)
    return {m: (dict(np.load(d / f"m{m[0]}x{m[1]}" / "pipeline.npz")),
                json.loads((d / f"m{m[0]}x{m[1]}" / "counts.json")
                           .read_text()))
            for m in MESHES}


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_spmd2d_matches_jax_and_port(mesh, runs, jax_ref, port_ref):
    """Keys whole and live rows [:r-1] of the padded ciphertexts equal JAX
    xla and the port's single device; every message round-trips; the
    collectives are JAX's HLO budget: keygen 3 log2 C ppermutes of the
    (rl, S) block and no all-reduce, encrypt 2 log2 C ppermutes ((rl, S)
    then (2, rl, S)) and one (2, S) all-reduce, decrypt 2 log2 C
    ppermutes and one (3, S) all-reduce."""
    got, counts = runs[mesh]
    for k in ("sk", "pk"):
        np.testing.assert_array_equal(got[k], jax_ref[1][k], err_msg=k)
        np.testing.assert_array_equal(got[k], port_ref[k], err_msg=k)
    for k in ("ct_a", "ct_b"):
        assert got[k].shape == (2, R_MODULI, N)
        live = got[k][:, :R_MODULI - 1]
        np.testing.assert_array_equal(live, jax_ref[1][k], err_msg=k)
        np.testing.assert_array_equal(live, port_ref[k], err_msg=k)
    m1, m2 = _messages(1024)
    for k, w in (("dec_a", m1), ("dec_b", m2), ("dec_jax_in", m1)):
        np.testing.assert_array_equal(got[k], w.astype(np.uint64),
                                      err_msg=k)
    R, C = mesh
    rl, S = R_MODULI // R, N // C
    logc = C.bit_length() - 1
    blk = ["ppermute", [rl, S]]
    assert counts == {
        "keygen": [blk] * (3 * logc),
        "encrypt": [blk] * logc + [["ppermute", [2, rl, S]]] * logc
        + [["all_reduce", [2, S]]],
        "decrypt": [blk] * (2 * logc) + [["all_reduce", [3, S]]]}
