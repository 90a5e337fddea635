"""The RNS-sharded context of the port (ntt_cuda_tpu_torch/parallel/rns.py,
ShardedBFVContext) in real processes, against the JAX package's and the
port's single-card contexts, exactly (tolerance 0).

Workers run this file as a script (the `__main__` below, one subprocess a
rank, as tests/test_torch_spmd2d.py runs its workers), so that they import
the port alone; they start a gloo process group with a file:// address in
the test's temporary directory and write their results as .npz / .json
files.

On a (2, 2) ('rns', 'coef') mesh, four processes ('coef' replicated, as
in the JAX package), n = 1024 and 28-bit moduli, two sets: r = 4, which
R = 2 divides (the SPMD programs run decrypt, mul, square, the keygens
and apply_galois; the next level, r = 3, runs on `inner`), and r = 5,
which it does not (everything on `inner`; its next level, r = 4, runs
sharded).  Every one of the 16 methods of the JAX wrapper (keygen,
encrypt, decrypt, add, sub, mul, relin_keygen, galois_keygen,
apply_galois, square, add_plain, mul_plain, encrypt_batch, decrypt_batch,
next_context, mod_switch_to_next), as tests/test_parallel.py calls them,
must equal JAX's `BFVContext.build(params, backend="xla")` and the port's
`BFVContext(device="cpu")` on the same inputs; outputs placed by the JAX
package's rule (key_sharding / ct_sharding / rlk_sharding); DTensor
arguments taken too.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
N, BITS = 1024, 28
SETS = (4, 5)             # r: R = 2 divides 4 (sharded), not 5 (inner)
MESH = (2, 2)
SEED = 0x2A5
GALOIS, GALOIS_NONCE, RELIN_NONCE = 3, 5, 1
BATCH_NONCES = (7, 8)


def _messages(t: int):
    return np.random.default_rng(SEED).integers(0, t, (2, N), dtype=np.int64)


def _keys(ctx) -> dict:
    """The first half of the 16 methods' calls on one context (the sharded
    or a single-card one), in tests/test_parallel.py's manner: keygen,
    encrypt, the switching keys and the elementwise ops."""
    p = ctx.inner.params if hasattr(ctx, "inner") else ctx.params
    m1, m2 = _messages(p.t)
    sk, pk = ctx.keygen()
    c1, c2 = ctx.encrypt(pk, m1), ctx.encrypt(pk, m2)
    return {"sk": sk, "pk": pk, "c1": c1, "c2": c2,
            "rlk": ctx.relin_keygen(sk, nonce=RELIN_NONCE),
            "gk": ctx.galois_keygen(sk, [GALOIS],
                                    nonce=GALOIS_NONCE)[GALOIS],
            "add": ctx.add(c1, c2), "sub": ctx.sub(c1, c2),
            "add_plain": ctx.add_plain(c1, m2),
            "mul_plain": ctx.mul_plain(c1, m2)}


def _evaluate(ctx, a: dict, as_key=lambda sk: sk) -> dict:
    """The second half on _keys' outputs `a`: mul, square, apply_galois,
    the decrypts, the batch, the mod switch and the next level.  `as_key`
    gives the sk argument of one decrypt a second form."""
    p = ctx.inner.params if hasattr(ctx, "inner") else ctx.params
    m1, m2 = _messages(p.t)
    sk, c1, c2, rlk = a["sk"], a["c1"], a["c2"], a["rlk"]
    out = {"ct3": ctx.mul(c1, c2), "mul_rlk": ctx.mul(c1, c2, rlk=rlk),
           "mul_add": ctx.mul(a["add"], c1), "square": ctx.square(c1),
           "square_rlk": ctx.square(c1, rlk=rlk),
           "galois": ctx.apply_galois(c1, GALOIS, a["gk"]),
           "dec": ctx.decrypt(as_key(sk), c1)}
    out["dec3"] = ctx.decrypt(sk, out["ct3"])
    out["dec_rlk"] = ctx.decrypt(sk, out["mul_rlk"])
    out["batch"] = ctx.encrypt_batch(a["pk"], np.stack([m1, m2]),
                                     np.array(BATCH_NONCES, np.uint64))
    out["dec_batch"] = ctx.decrypt_batch(sk, out["batch"])
    out["switched"] = ctx.mod_switch_to_next(c1)
    out["dec_next"] = ctx.next_context().decrypt(sk[:p.r - 1],
                                                 out["switched"])
    return out


def _calls(ctx, as_key=lambda sk: sk) -> dict:
    """The 16 methods on one context: {name: output}."""
    a = _keys(ctx)
    return {**a, **_evaluate(ctx, a, as_key)}


class _Jax:
    """JAX's single-card context behind _calls' interface: numpy in and
    out, its nonce-free encrypt (the JAX wrapper's) and its next level."""

    def __init__(self, ctx):
        self.ctx, self.params = ctx, ctx.params

    def __getattr__(self, name):
        import jax.numpy as jnp
        fn = getattr(self.ctx, name)

        def call(*a, **kw):
            a = [jnp.asarray(x) if isinstance(x, np.ndarray) else x
                 for x in a]
            y = fn(*a, **kw)
            if isinstance(y, dict):
                return {g: np.asarray(v) for g, v in y.items()}
            if isinstance(y, tuple):
                return tuple(np.asarray(v) for v in y)
            return np.asarray(y)
        return call

    def encrypt(self, pk, m):
        import jax.numpy as jnp
        return np.asarray(self.ctx.encrypt(jnp.asarray(pk),
                                           jnp.asarray(m.astype(np.uint64))))

    def next_context(self):
        return _Jax(self.ctx.next_context())


def _jax_reference(r: int, half: str, out: Path) -> None:
    """JAX's single-card outputs of the set with r moduli, one half of the
    calls, to out/jax_r<r>_<half>.npz (this file run as `--jax r half
    out`, one process a set and half, all at once, on the CPU as
    tests/conftest.py runs JAX).  The second half takes the port's first
    half (out/port_r<r>.npz, written by the test process; it equals JAX's,
    which the first half's comparisons check)."""
    import time

    import jax
    jax.config.update("jax_platforms", "cpu")
    from ntt_cuda_tpu.models import bfv as jbfv
    from ntt_cuda_tpu.utils import primegen as jprimegen

    ctx = _Jax(jbfv.BFVContext.build(jprimegen.make_bfv_params(N, BITS, r),
                                     backend="xla"))
    if half == "keys":
        res = _keys(ctx)
    else:
        port = out / f"port_r{r}.npz"
        end = time.monotonic() + 300
        while not port.exists():
            if time.monotonic() > end:
                raise TimeoutError(f"{port} never appeared")
            time.sleep(0.1)
        res = _evaluate(ctx, dict(np.load(port)))
    np.savez(out / f"jax_r{r}_{half}.npz",
             **{k: np.asarray(v).astype(np.uint64) for k, v in res.items()})


# --- the workers (port only) ------------------------------------------------

def _pipeline(rank: int, out: Path) -> None:
    from torch.distributed.tensor import DTensor
    from ntt_cuda_tpu_torch import convert
    from ntt_cuda_tpu_torch.parallel import mesh, rns
    from ntt_cuda_tpu_torch.utils import primegen

    pod = mesh.make_mesh(*MESH, device_type="cpu")
    for r in SETS:
        ctx = rns.ShardedBFVContext.build(primegen.make_bfv_params(N, BITS, r),
                                          mesh=pod, device="cpu")
        counts = {}

        class Counted:
            """ctx's methods with each call's collectives logged."""
            def __getattr__(self, name):
                fn = getattr(ctx, name)

                def call(*a, **kw):
                    mesh.collectives.clear()
                    y = fn(*a, **kw)
                    counts.setdefault(name, []).append(
                        [[op, list(s)] for op, s in mesh.collectives])
                    return y
                return call if callable(fn) else fn

        res = _calls(Counted(), lambda sk: ctx._place(sk, ctx.key_sharding()))
        placed = {k: [repr(p) for p in v.placements] for k, v in res.items()
                  if isinstance(v, DTensor)}
        arrays = {k: convert.from_dtensor(v) if isinstance(v, DTensor)
                  else convert.to_numpy(v) for k, v in res.items()}
        if rank == 0:
            np.savez(out / f"r{r}.npz", **arrays)
            (out / f"r{r}.json").write_text(json.dumps({
                "placed": placed, "counts": counts,
                "rule": [[repr(p) for p in f()] for f in (
                    ctx.key_sharding, ctx.ct_sharding, ctx.rlk_sharding)],
                "sharded": ctx.spmd is not None,
                "next_sharded": ctx.next_context().spmd is not None}))


def _worker(rank: int, out: Path) -> None:
    import torch
    torch.set_num_threads(1)
    from ntt_cuda_tpu_torch.parallel import multihost
    multihost.initialize(f"file://{out / 'init'}", MESH[0] * MESH[1], rank,
                         backend="gloo")
    try:
        _pipeline(rank, out)
        assert "jax" not in sys.modules, "a worker imported jax"
    finally:
        import torch.distributed as dist
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    if sys.argv[1] == "--jax":
        _jax_reference(int(sys.argv[2]), sys.argv[3], Path(sys.argv[4]))
    else:
        _worker(int(sys.argv[1]), Path(sys.argv[2]))
    sys.exit(0)

import pytest  # noqa: E402


# --- the test process ---------------------------------------------------------

class _Port:
    """The port's single-card context behind _calls' interface."""

    def __init__(self, ctx):
        self.ctx, self.params = ctx, ctx.params

    def __getattr__(self, name):
        return getattr(self.ctx, name)

    def next_context(self):
        return _Port(self.ctx.next_context())


def _port_references(d: Path) -> dict:
    """{r: the port's single-card outputs} as numpy uint64; each set's
    first half also to d/port_r<r>.npz for JAX's second half."""
    from ntt_cuda_tpu_torch import convert
    from ntt_cuda_tpu_torch.models import bfv
    from ntt_cuda_tpu_torch.utils import primegen

    refs = {}
    for r in SETS:
        ctx = _Port(bfv.BFVContext.build(primegen.make_bfv_params(N, BITS, r),
                                         device="cpu"))
        a = {k: convert.to_numpy(v) for k, v in _keys(ctx).items()}
        np.savez(d / f"port_r{r}.tmp.npz", **a)
        os.replace(d / f"port_r{r}.tmp.npz", d / f"port_r{r}.npz")
        refs[r] = {**a, **{k: convert.to_numpy(v) for k, v in
                           _evaluate(ctx, a).items()}}
    return refs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """({r: (the workers' arrays, their placements and collectives)},
    {r: (JAX's outputs, the port's)}).  The workers and one JAX process a
    set and half run while the test process computes the port's
    references (on one torch thread, as the workers do)."""
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    d = tmp_path_factory.mktemp("rns")
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    start = lambda args, env: subprocess.Popen(
        [sys.executable, __file__, *args, str(d)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env, cwd=str(ROOT))
    procs = {f"rank {rank}": start([str(rank)], env)
             for rank in range(MESH[0] * MESH[1])}
    # XLA's backend optimisation off in the JAX processes (a third less
    # compile time, the same integers), one thread each
    jax_env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=(
        "--xla_backend_optimization_level=0 "
        "--xla_cpu_multi_thread_eigen=false"))
    procs.update({f"JAX r={r} {half}": start(["--jax", str(r), half],
                                             jax_env)
                  for r in SETS for half in ("keys", "evaluate")})
    outs = {}
    try:
        port = _port_references(d)
        outs = {k: proc.communicate(timeout=300)[0]
                for k, proc in procs.items()}
    finally:
        torch.set_num_threads(threads)
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for k, proc in procs.items():
        assert proc.returncode == 0, f"{k} failed:\n{outs[k]}"
    got = {r: (dict(np.load(d / f"r{r}.npz")),
               json.loads((d / f"r{r}.json").read_text())) for r in SETS}
    jax_ = {r: {k: v for half in ("keys", "evaluate") for k, v in
                np.load(d / f"jax_r{r}_{half}.npz").items()} for r in SETS}
    return got, {r: (jax_[r], port[r]) for r in SETS}


METHOD_OUTPUTS = {
    "keygen": ("sk", "pk"), "encrypt": ("c1", "c2"),
    "decrypt": ("dec", "dec3", "dec_rlk"), "add": ("add",), "sub": ("sub",),
    "mul": ("ct3", "mul_rlk", "mul_add"), "relin_keygen": ("rlk",),
    "galois_keygen": ("gk",), "apply_galois": ("galois",),
    "square": ("square", "square_rlk"), "add_plain": ("add_plain",),
    "mul_plain": ("mul_plain",), "encrypt_batch": ("batch",),
    "decrypt_batch": ("dec_batch",), "next_context": ("dec_next",),
    "mod_switch_to_next": ("switched",)}


@pytest.mark.parametrize("r", SETS, ids=lambda r: f"r{r}")
@pytest.mark.parametrize("method", sorted(METHOD_OUTPUTS))
def test_rns_method_equals_jax_and_port(runs, r, method):
    """The method's outputs equal the single-card JAX and port outputs of
    the same calls (the decrypts also the message, and the product's the
    single card's)."""
    got, refs = runs
    arrays, jax_, port = got[r][0], *refs[r]
    for k in METHOD_OUTPUTS[method]:
        assert arrays[k].shape == jax_[k].shape, k
        np.testing.assert_array_equal(arrays[k], jax_[k], err_msg=k)
        np.testing.assert_array_equal(arrays[k], port[k], err_msg=k)
    if method == "decrypt":
        m1 = _messages(1024)[0].astype(np.uint64)
        np.testing.assert_array_equal(arrays["dec"], m1)


@pytest.mark.parametrize("r", SETS, ids=lambda r: f"r{r}")
def test_rns_placements_follow_jax_rule(runs, r):
    """key / ct / rlk placements shard 'rns' where R = 2 divides the row
    count (r, r-1, r), else replicate; 'coef' replicated.  Ciphertext
    outputs take ct_sharding() (mod_switch_to_next the next level's),
    switching keys rlk_sharding(); the branch is r % R == 0's."""
    got, _ = runs
    meta = got[r][1]
    R = MESH[0]
    rep = "Replicate()"
    rule = lambda rows, dim: [f"Shard(dim={dim})" if rows % R == 0 else rep,
                              rep]
    key, ct, rlk = rule(r, 0), rule(r - 1, 1), rule(r, 2)
    assert meta["rule"] == [key, ct, rlk]
    assert meta["sharded"] == (r % R == 0)
    assert meta["next_sharded"] == ((r - 1) % R == 0)
    want = {k: ct for k in ("add", "sub", "ct3", "mul_rlk", "mul_add",
                            "square", "square_rlk", "galois", "add_plain",
                            "mul_plain")}
    want.update(rlk=rlk, gk=rlk, switched=rule(r - 2, 1))
    assert meta["placed"] == want


@pytest.mark.parametrize("r", SETS, ids=lambda r: f"r{r}")
def test_rns_collectives_by_branch(runs, r):
    """Sharded branch (r = 4): every decrypt one (3, n) all-reduce over
    'rns' (L = 3: decrypt3's), decrypt_batch one (3, J, n) for its J
    messages; mul spmd_mult's four all-gathers (with rlk
    also the key switch's all-gather and all-reduce), then one of the
    padded product to ct_sharding (Replicate).  Inner branch (r = 5):
    none, but one all-gather of each DTensor argument sharded over 'rns'
    (ct_sharding Shard(1): mul's and decrypt's of mul and add outputs).
    The keygens, encrypts and the elementwise ops none in either."""
    got, _ = runs
    counts = got[r][1]["counts"]
    ag, ar = "all_gather", "all_reduce"
    for op in ("keygen", "encrypt", "relin_keygen", "galois_keygen", "add",
               "sub", "add_plain", "mul_plain", "encrypt_batch"):
        assert all(c == [] for c in counts[op]), op
    if r % MESH[0] == 0:
        front = [[ag, [2, r, N]]] * 2 + [[ag, [3, r, N]]] * 2
        switch = [[ag, [r, N]], [ar, [2, N]]]
        assert counts["mul"] == [front + [[ag, [3, r, N]]],
                                 front + switch + [[ag, [2, r, N]]],
                                 front + [[ag, [3, r, N]]]]
        assert counts["decrypt"] == [[[ar, [3, N]]]] * 3
        assert counts["decrypt_batch"] == [[[ar, [3, len(BATCH_NONCES),
                                                  N]]]]
    else:
        assert counts["decrypt_batch"] == [[]]
        assert counts["mul"] == [[], [], [[ag, [2, r - 1, N]]]]
        assert counts["decrypt"] == [[], [[ag, [3, r - 1, N]]],
                                     [[ag, [2, r - 1, N]]]]
