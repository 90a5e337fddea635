"""The RNS-sharded BFV program of the port (ntt_cuda_tpu_torch/parallel)
in real processes, against the JAX package and the port's single-device
context, exactly.

Workers run this file as a script (the `__main__` below, one subprocess a
rank, as tests/test_multihost.py runs its worker), so that they import the
port alone: no jax, no tests/conftest.py.  They start a gloo process group
through `multihost.initialize` with a file:// address in the test's
temporary directory (no port to race for between pytest workers) and write
their results as .npz / .json files; the test process compares them.

* The pipeline at R = 2 and R = 4 ranks, n = 2048, r = 4 moduli (rl = 2
  and 1): keygen at nonces 0 and 3, encrypt at nonces 0 and 9, add, sub,
  decrypt, mod_switch_to_next and the level-1 decrypt, the prime-t
  encoder round trip, and a decrypt of the JAX package's own key and
  ciphertext carried in by `convert.to_dtensor`.  Keys and live
  ciphertext rows must equal JAX's `BFVContext.build(params,
  backend="xla")` (the contract tests/test_spmd.py holds JAX's own SPMD
  program to) and the port's `BFVContext(device="cpu")`; every message
  must round-trip; the collectives must be keygen none, encrypt one
  all-reduce of (2, n), decrypt one of (3, n), mod_switch one of (2, n).
* `multihost.initialize` + `pod_mesh` in two processes.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
N, BITS, R_MODULI = 2048, 40, 4
SEED = 0x5EED


def _messages(t: int):
    rng = np.random.default_rng(SEED)
    return rng.integers(0, t, (3, N), dtype=np.int64)  # m1, m2, slots


def _odd_t() -> int:
    from ntt_cuda_tpu_torch.utils import primegen
    return primegen.find_plain_modulus(N, 17)


# --- the workers (port only) ------------------------------------------------

def _pipeline(rank: int, out: Path) -> None:
    import torch
    from ntt_cuda_tpu_torch import convert
    from ntt_cuda_tpu_torch.models import encoder
    from ntt_cuda_tpu_torch.parallel import mesh, spmd
    from ntt_cuda_tpu_torch.utils import primegen

    counts = {}

    def counted(name, fn):
        mesh.collectives.clear()
        y = fn()
        counts[name] = [[op, list(shape)] for op, shape in
                        mesh.collectives]
        return y

    p = primegen.make_bfv_params(N, BITS, R_MODULI)
    ctx = spmd.SpmdBFVContext.build(p, device="cpu")
    m1, m2, _ = (torch.from_numpy(m) for m in _messages(p.t))
    sk, pk = counted("keygen", ctx.keygen)
    sk3, pk3 = ctx.keygen(nonce=3)
    ct_a = counted("encrypt", lambda: ctx.encrypt(pk, m1))
    ct_b = ctx.encrypt(pk, m2, nonce=9)
    ct_c = ctx.encrypt(pk3, m1, nonce=9)
    add = counted("add", lambda: ctx.add(ct_a, ct_b))
    sub = counted("sub", lambda: ctx.sub(ct_a, ct_b))
    dec_a = counted("decrypt", lambda: ctx.decrypt(sk, ct_a))
    sw = counted("mod_switch", lambda: ctx.mod_switch_to_next(ct_a))
    ins = np.load(out.parent / "jax_inputs.npz")
    jsk = convert.to_dtensor(ins["sk"], ctx.mesh, 0)
    jct = convert.to_dtensor(ins["ct_padded"], ctx.mesh, 1)
    res = {
        "sk": sk, "pk": pk, "sk3": sk3, "pk3": pk3, "ct_a": ct_a,
        "ct_b": ct_b, "ct_c": ct_c, "add": add, "sub": sub, "sw": sw,
        "dec_a": dec_a, "dec_b": ctx.decrypt(sk, ct_b),
        "dec_c": ctx.decrypt(sk3, ct_c), "dec_add": ctx.decrypt(sk, add),
        "dec_sub": ctx.decrypt(sk, sub),
        "dec_sw": ctx.decrypt(sk, sw, level=1),
        "dec_jax_in": ctx.decrypt(jsk, jct),
        # full arrays in: each rank slices its own rows, nothing is sent
        "dec_full_in": ctx.decrypt(ins["sk"], ins["ct_padded"]),
    }
    pt = primegen.make_bfv_params(N, BITS, R_MODULI, t=_odd_t())
    ctx_t = spmd.SpmdBFVContext.build(pt, mesh=ctx.mesh, device="cpu")
    enc = encoder.BatchEncoder(pt, device="cpu")
    slots = _messages(pt.t)[2]
    skt, pkt = ctx_t.keygen()
    res["ct_t"] = ctx_t.encrypt(pkt, enc.encode(slots), nonce=11)
    res["slots_t"] = enc.decode(ctx_t.decrypt(skt, res["ct_t"]).to_local())
    arrays = {k: (convert.from_dtensor(v) if hasattr(v, "full_tensor")
                  else convert.to_numpy(v)) for k, v in res.items()}
    if rank == 0:
        np.savez(out / "pipeline.npz", **arrays)
        (out / "counts.json").write_text(json.dumps(counts))


def _pod(rank: int, out: Path) -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard
    from ntt_cuda_tpu_torch.parallel import mesh, multihost

    assert multihost.is_coordinator() == (rank == 0)
    pod = multihost.pod_mesh(device_type="cpu")   # one process a host
    os.environ["LOCAL_WORLD_SIZE"] = "2"
    pod2 = multihost.pod_mesh(device_type="cpu")  # both on one host
    x = torch.full((4,), rank + 1, dtype=torch.int64)
    mesh.all_reduce(x, pod.get_group("rns"))
    res = {"pod": list(pod.shape), "pod2": list(pod2.shape),
           "names": list(pod.mesh_dim_names),
           "sum": x.tolist(), "log": mesh.collectives,
           "residue": mesh.residue_sharding(pod, 3) == [Shard(1),
                                                       Replicate()],
           "coef": mesh.residue_sharding(pod2, 3, shard_coef=True)
           == [Shard(1), Shard(2)],
           "table": mesh.table_sharding(pod) == [Shard(0), Replicate()],
           "repl": mesh.replicated(pod) == [Replicate(), Replicate()]}
    dist.barrier()
    (out / f"pod{rank}.json").write_text(json.dumps(res))


def _worker(kind: str, R: int, rank: int, out: Path) -> None:
    import torch
    torch.set_num_threads(1)
    from ntt_cuda_tpu_torch.parallel import multihost
    multihost.initialize(f"file://{out / 'init'}", R, rank, backend="gloo")
    try:
        {"pipeline": _pipeline, "pod": _pod}[kind](rank, out)
        assert "jax" not in sys.modules, "a worker imported jax"
    finally:
        import torch.distributed as dist
        dist.destroy_process_group()


# --- the test process ---------------------------------------------------------

def _spawn(kind: str, R: int, out: Path) -> None:
    """R workers of `kind`, all started together; raises with the output
    of any that fails."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [subprocess.Popen(
        [sys.executable, __file__, kind, str(R), str(rank), str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=str(ROOT)) for rank in range(R)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"{kind} worker {rank}/{R} failed:\n{o}"


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
            Path(sys.argv[4]))
    sys.exit(0)

import pytest  # noqa: E402


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """The JAX package's single-chip xla pipeline on the same inputs, and
    its key and (padded) ciphertext for the workers to carry in."""
    import jax.numpy as jnp
    from ntt_cuda_tpu.models import bfv, encoder
    from ntt_cuda_tpu.utils import primegen

    jp = primegen.make_bfv_params(N, BITS, R_MODULI)
    ref = bfv.BFVContext.build(jp, backend="xla")
    m1, m2, _ = (jnp.asarray(m.astype(np.uint64)) for m in _messages(jp.t))
    sk, pk = ref.keygen()
    sk3, pk3 = ref.keygen(nonce=3)
    ct_a = ref.encrypt(pk, m1)
    ct_b = ref.encrypt(pk, m2, nonce=9)
    sw = ref.mod_switch_to_next(ct_a)
    res = {"sk": sk, "pk": pk, "sk3": sk3, "pk3": pk3, "ct_a": ct_a,
           "ct_b": ct_b, "ct_c": ref.encrypt(pk3, m1, nonce=9),
           "add": ref.add(ct_a, ct_b), "sub": ref.sub(ct_a, ct_b), "sw": sw,
           "dec_sw": ref.next_context().decrypt(sk, sw)}
    jpt = primegen.make_bfv_params(N, BITS, R_MODULI, t=_odd_t())
    ref_t = bfv.BFVContext.build(jpt, backend="xla")
    enc = encoder.BatchEncoder(jpt)
    skt, pkt = ref_t.keygen()
    res["ct_t"] = ref_t.encrypt(pkt, enc.encode(jnp.asarray(
        _messages(jpt.t)[2].astype(np.uint64))), nonce=11)
    res = {k: np.asarray(v).astype(np.uint64) for k, v in res.items()}
    d = tmp_path_factory.mktemp("spmd_jax")
    padded = np.concatenate([res["ct_a"],
                             np.zeros((2, 1, N), np.uint64)], axis=1)
    np.savez(d / "jax_inputs.npz", sk=res["sk"], ct_padded=padded)
    return d, res


@pytest.fixture(scope="module")
def port_ref():
    """The port's single-device context on the CPU, the same calls."""
    from ntt_cuda_tpu_torch import convert
    from ntt_cuda_tpu_torch.models import bfv, encoder
    from ntt_cuda_tpu_torch.utils import primegen

    ctx = bfv.BFVContext.build(primegen.make_bfv_params(N, BITS, R_MODULI),
                               device="cpu")
    m1, m2, _ = _messages(ctx.params.t)
    sk, pk = ctx.keygen()
    sk3, pk3 = ctx.keygen(nonce=3)
    ct_a = ctx.encrypt(pk, m1)
    ct_b = ctx.encrypt(pk, m2, nonce=9)
    res = {"sk": sk, "pk": pk, "sk3": sk3, "pk3": pk3, "ct_a": ct_a,
           "ct_b": ct_b, "ct_c": ctx.encrypt(pk3, m1, nonce=9),
           "add": ctx.add(ct_a, ct_b), "sub": ctx.sub(ct_a, ct_b),
           "sw": ctx.mod_switch_to_next(ct_a)}
    pt = primegen.make_bfv_params(N, BITS, R_MODULI, t=_odd_t())
    ctx_t = bfv.BFVContext.build(pt, device="cpu")
    enc = encoder.BatchEncoder(pt, device="cpu")
    skt, pkt = ctx_t.keygen()
    res["ct_t"] = ctx_t.encrypt(pkt, enc.encode(_messages(pt.t)[2]),
                                nonce=11)
    return {k: convert.to_numpy(v) for k, v in res.items()}


@pytest.fixture(scope="module", params=[2, 4], ids=lambda R: f"R{R}")
def spmd_run(request, jax_ref, tmp_path_factory):
    """The workers' outputs and collective log at R ranks."""
    R = request.param
    d, _ = jax_ref
    out = d / f"R{R}"
    out.mkdir()
    _spawn("pipeline", R, out)
    return (R, dict(np.load(out / "pipeline.npz")),
            json.loads((out / "counts.json").read_text()))


def _live(ct, width):
    return ct[:, :width]


def test_spmd_keys_equal_jax_and_port(spmd_run, jax_ref, port_ref):
    _, got, _ = spmd_run
    for k in ("sk", "pk", "sk3", "pk3"):
        np.testing.assert_array_equal(got[k], jax_ref[1][k], err_msg=k)
        np.testing.assert_array_equal(got[k], port_ref[k], err_msg=k)


def test_spmd_ciphertexts_equal_jax_and_port(spmd_run, jax_ref, port_ref):
    """Live rows [:r-1] of the padded ciphertexts, and of add and sub."""
    _, got, _ = spmd_run
    for k in ("ct_a", "ct_b", "ct_c", "add", "sub", "ct_t"):
        assert got[k].shape == (2, R_MODULI, N)
        np.testing.assert_array_equal(_live(got[k], R_MODULI - 1),
                                      jax_ref[1][k], err_msg=k)
        np.testing.assert_array_equal(_live(got[k], R_MODULI - 1),
                                      port_ref[k], err_msg=k)


def test_spmd_decrypt_round_trips(spmd_run):
    _, got, _ = spmd_run
    m1, m2, _ = _messages(1024)
    t = 1024
    want = {"dec_a": m1, "dec_b": m2, "dec_c": m1, "dec_add": (m1 + m2) % t,
            "dec_sub": (m1 - m2) % t, "dec_jax_in": m1, "dec_full_in": m1}
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w.astype(np.uint64),
                                      err_msg=k)


def test_spmd_mod_switch_equals_jax_and_port(spmd_run, jax_ref, port_ref):
    """Live rows [:r-2] after one switch; the level-1 decrypt equals the
    message and JAX's next-context decrypt."""
    _, got, _ = spmd_run
    np.testing.assert_array_equal(_live(got["sw"], R_MODULI - 2),
                                  jax_ref[1]["sw"])
    np.testing.assert_array_equal(_live(got["sw"], R_MODULI - 2),
                                  port_ref["sw"])
    np.testing.assert_array_equal(got["dec_sw"], jax_ref[1]["dec_sw"])
    np.testing.assert_array_equal(got["dec_sw"],
                                  _messages(1024)[0].astype(np.uint64))


def test_spmd_prime_t_encoder_round_trip(spmd_run):
    _, got, _ = spmd_run
    np.testing.assert_array_equal(
        got["slots_t"], _messages(_odd_t())[2].astype(np.uint64))


def test_spmd_collective_counts(spmd_run):
    """The counterpart of tests/test_collectives.py's HLO budget: keygen
    none, encrypt one (2, n) all-reduce, decrypt one (3, n), mod_switch one
    (L = 2, n); add and sub none."""
    _, _, counts = spmd_run
    assert counts == {"keygen": [], "encrypt": [["all_reduce", [2, N]]],
                      "add": [], "sub": [],
                      "decrypt": [["all_reduce", [3, N]]],
                      "mod_switch": [["all_reduce", [2, N]]]}


def test_two_process_pod_mesh(tmp_path):
    """multihost.initialize (gloo) + pod_mesh in two processes: the default
    layout (one process a host: rns 2, coef 1; both on one host: rns 1,
    coef 2), an all-reduce over the rns group, the placement helpers."""
    _spawn("pod", 2, tmp_path)
    for rank in range(2):
        res = json.loads((tmp_path / f"pod{rank}.json").read_text())
        assert res["pod"] == [2, 1] and res["pod2"] == [1, 2]
        assert res["names"] == ["rns", "coef"]
        assert res["sum"] == [3] * 4
        assert res["log"] == [["all_reduce", [4]]]
        assert res["residue"] and res["coef"] and res["table"] and res["repl"]
