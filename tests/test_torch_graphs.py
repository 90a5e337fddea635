"""CUDA-graph replay of the op programs and the chained-slope timing
(utils/profiling.py), with no JAX (the card's machine has none).

On the CPU: `graphed`'s eager path, `time_chained` /
`time_chained_dynamic` / `time_once` on the CLI's decrypt chain and on a
chain of sleeps of known cost, and `trace`'s Chrome trace, with the
library's own spans in it (`demo --time`: tests/test_torch_cli.py).  On
the card (`-m gpu`, skipped here): every op program at 4k_3q captured once with `graphed` and
replayed equals the eager public method bit for bit, a replay after a
second nonce is copied into the static input equals eager at that nonce,
and a capture on the card never falls back to eager calls.
"""

import json
import time

import numpy as np
import pytest
import torch

from ntt_cuda_tpu_torch import BFVContext, cli, get_bfv_params
from ntt_cuda_tpu_torch.utils import profiling

SET = "4k_3q"
SLEEP_S = 0.002   # a step of known cost for the slopes


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (the suite runs several
    worker processes at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def cpu_ctx():
    return BFVContext.build(get_bfv_params(SET), device="cpu")


def _nonce(v: int, device) -> torch.Tensor:
    return torch.tensor(np.uint64(v).view(np.int64), device=device)


def test_graphed_eager_path_reruns_into_static_outputs(cpu_ctx):
    """On the CPU the replay callable runs fn again and writes its static
    outputs in place: the output tensors are the same objects after a new
    nonce is copied in, holding the new keys."""
    kg_fn, *_, bz = cpu_ctx.op_programs()
    nonce = _nonce(3, "cpu")
    g = profiling.graphed(kg_fn, nonce, bz)
    assert g.graph is None and g.inputs[0] is nonce
    sk_obj = g.outputs[0]
    nonce.copy_(_nonce(4, "cpu"))
    sk, pk = g()
    assert sk is sk_obj
    ref = cpu_ctx.keygen(nonce=4)
    assert torch.equal(sk, ref[0]) and torch.equal(pk, ref[1])


def test_graphed_sees_the_bundles_tensors(cpu_ctx):
    """graphed picks its device from every tensor its args reach: those of
    the bundles' tables and constants (dataclasses) are among them."""
    *_, bz = cpu_ctx.op_programs()
    seen = {id(t) for t in profiling._tensors((_nonce(1, "cpu"), bz))}
    assert id(bz["tf"].ms.q) in seen and id(bz["tc"].tail_rows) in seen
    assert len(seen) > len(bz)


def test_time_chained_on_the_cpu(cpu_ctx):
    """The chains run eagerly under the host clock.  The decrypt chain's
    slope is a number, clamped at 0 (two short chains of real ops on a
    loaded CPU can read 0).  On a chain of known cost, k sleeps of 2 ms,
    both forms read a positive slope in a wide band around 2 ms: a sleep
    never ends early, so the long chain takes at least its 2 ms a step,
    and the band's floor leaves room for noise on the short one.
    time_once is positive."""
    p = cpu_ctx.params
    m = torch.arange(p.n, dtype=torch.int64) % p.t
    sk, pk = cpu_ctx.keygen(nonce=1)
    ct = cpu_ctx.encrypt(pk, m, nonce=2)
    _, _, dec_make = cli.phase_chains(cpu_ctx, sk, pk, m)
    assert profiling.time_chained(dec_make, ct, 1, 6, reps=2) >= 0

    def make_step(k):
        def chain(x):
            for _ in range(k):
                time.sleep(SLEEP_S)
            return x
        return chain

    def step(x, k):
        return make_step(k)(x)
    x = torch.zeros(1)
    assert SLEEP_S / 4 < profiling.time_chained(make_step, x, 1, 11,
                                                reps=3) < 20 * SLEEP_S
    assert SLEEP_S / 4 < profiling.time_chained_dynamic(
        step, x, inner_lo=1, inner_hi=11, reps=1, epochs=2) < 20 * SLEEP_S
    assert profiling.time_once(cpu_ctx.decrypt, sk, ct, reps=2) > 0


def test_trace_writes_a_chrome_trace(tmp_path, cpu_ctx):
    sk, pk = cpu_ctx.keygen(nonce=1)
    with profiling.trace(str(tmp_path)) as prof:
        cpu_ctx.encrypt(pk, torch.zeros(cpu_ctx.params.n, dtype=torch.int64))
    files = list(tmp_path.glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert events
    # the library's own spans, in the operator's view of the timeline
    names = {e.get("name") for e in events}
    assert {"ntt.encrypt", "ntt.draws"} <= names
    assert len(prof.key_averages()) > 0


# --- on the card --------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: graphs capture only on the card")
    return torch.device("cuda", torch.cuda.current_device())


def _programs(ctx, seed: int):
    """Each program of ctx as (name, fn, args, eager(args)), on inputs made
    from a seed: keys at nonce 5, m and a second message encrypted at 6
    and 7, a J = 16 batch, a J = 3 batch of ciphertexts."""
    p, dev = ctx.params, ctx.device
    kg_fn, enc_fn, dec_fn, encb_fn, decb_fn, bz = ctx.op_programs()
    mul_fn, sq_fn, mbz = ctx.mult_program()
    rng = np.random.default_rng(seed)
    m = torch.from_numpy(rng.integers(0, p.t, (16, p.n))).to(dev)
    sk, pk = ctx.keygen(nonce=5)
    rlk = ctx.relin_keygen(sk, nonce=1)
    ct, ct2 = ctx.encrypt(pk, m[0], nonce=6), ctx.encrypt(pk, m[1], nonce=7)
    cts = ctx.encrypt_batch(pk, m[:3], [1, 2, 3])
    n16 = torch.arange(1, 17, dtype=torch.int64, device=dev)
    return [
        ("kg", kg_fn, (_nonce(5, dev), bz),
         lambda a: ctx.keygen(nonce=int(a[0]))),
        ("enc", enc_fn, (_nonce(6, dev), pk, m[0], bz),
         lambda a: ctx.encrypt(a[1], a[2], nonce=int(a[0]))),
        ("dec", dec_fn, (sk, ct, bz), lambda a: ctx.decrypt(a[0], a[1])),
        ("dec_drop", dec_fn, (sk[: p.r - 1], ct, bz),
         lambda a: ctx.decrypt(a[0], a[1])),
        ("enc_batch", encb_fn, (n16, pk, m, bz),
         lambda a: ctx.encrypt_batch(a[1], a[2], a[0].cpu().tolist())),
        ("dec_batch", decb_fn, (sk, cts, bz),
         lambda a: ctx.decrypt_batch(a[0], a[1])),
        ("mul_rlk", mul_fn, (ct, ct2, rlk, mbz),
         lambda a: ctx.mul(a[0], a[1], rlk=a[2])),
        ("mul3", mul_fn, (ct, ct2, None, mbz),
         lambda a: ctx.mul(a[0], a[1])),
        ("square_rlk", sq_fn, (ct, rlk, mbz),
         lambda a: ctx.square(a[0], rlk=a[1])),
    ]


def _flat(x) -> list:
    return [x] if isinstance(x, torch.Tensor) else list(x)


def _same(got, ref) -> bool:
    return all(torch.equal(g, r) for g, r in zip(_flat(got), _flat(ref)))


@pytest.mark.gpu
@pytest.mark.parametrize("fusion", ["op", "stage"])
def test_cuda_graph_replay_equals_eager(cuda_device, fusion):
    ctx = BFVContext.build(get_bfv_params(SET), device=cuda_device,
                           fusion=fusion)
    for name, fn, args, eager in _programs(ctx, 1):
        g = profiling.graphed(fn, *args)
        assert g.graph is not None, name
        assert _same(g(), eager(args)), name


@pytest.mark.gpu
@pytest.mark.parametrize("fusion", ["op", "stage"])
def test_cuda_graph_replay_at_a_new_nonce(cuda_device, fusion):
    """A nonce copied into the static input after capture: the replay
    equals eager at the new nonce, and differs from the captured one's."""
    ctx = BFVContext.build(get_bfv_params(SET), device=cuda_device,
                           fusion=fusion)
    for name, fn, args, eager in _programs(ctx, 2):
        if name not in ("kg", "enc", "enc_batch"):
            continue
        g = profiling.graphed(fn, *args)
        first = [t.clone() for t in _flat(g())]
        args[0].copy_(args[0] + 1000)
        out = g()
        assert _same(out, eager(args)), name
        assert not all(torch.equal(a, b)
                       for a, b in zip(first, _flat(out))), name


@pytest.mark.gpu
def test_cuda_graphed_refuses_work_it_cannot_capture(cuda_device):
    """A host nonce beside the card's bundles, or a function whose work
    runs on the card while no argument is there, raises: neither runs
    eagerly in place of a capture."""
    ctx = BFVContext.build(get_bfv_params(SET), device=cuda_device)
    kg_fn, *_, bz = ctx.op_programs()
    with pytest.raises(ValueError, match="on the card"):
        profiling.graphed(kg_fn, _nonce(7, "cpu"), bz)
    with pytest.raises(ValueError, match="on the card"):
        profiling.graphed(lambda v: ctx.keygen(nonce=int(v)),
                          _nonce(7, "cpu"))
