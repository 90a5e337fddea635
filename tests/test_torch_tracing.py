"""The port's instrumentation (ntt_cuda_tpu_torch/utils/tracing.py): the
launch registry against the CUDA sources and the wrappers' code, spans on
only while torch.profiler records, and their nesting through the public
ops on the CPU.  On the card (`-m gpu`, skipped here): no span has a
device-side copy, and the registry's counts of one encrypt_batch equal the
kernel events family_of names."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import ntt_cuda_tpu_torch
from ntt_cuda_tpu_torch import BFVContext, get_bfv_params
from ntt_cuda_tpu_torch.utils import tracing

PKG = Path(ntt_cuda_tpu_torch.__file__).resolve().parent
SET = "4k_3q"
GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\((?:[^()]|"
                    r"\([^()]*\))*\)\s*)?(\w+)\s*\(")
LAUNCH_SITE = re.compile(r'tracing\.launch\("([\w.]+)"\)')


def csrc_kernels() -> set:
    return {m.group(1) for f in (PKG / "csrc").iterdir()
            for m in GLOBAL.finditer(f.read_text())}


def launch_sites() -> list:
    """(wrapper name, module file) of every tracing.launch call in the
    package."""
    return [(m.group(1), f) for f in PKG.rglob("*.py")
            for m in LAUNCH_SITE.finditer(f.read_text())]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def cpu_ctx():
    return BFVContext.build(get_bfv_params(SET), device="cpu")


def _cpu_profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


# --- the registry against the sources ----------------------------------------

def test_csrc_has_kernels():
    assert len(csrc_kernels()) == len(tracing.FAMILIES) > 0


@pytest.mark.parametrize("kernel", sorted(tracing.FAMILIES))
def test_every_registry_kernel_is_a_csrc_kernel(kernel):
    """Each family's kernel is a __global__ of csrc/, and each csrc/ kernel
    is a key of FAMILIES: one family each (test_csrc_has_kernels counts
    them equal)."""
    assert kernel in csrc_kernels()
    assert tracing.family_of(f"void {kernel}<3, 2>(Args)") == \
        tracing.FAMILIES[kernel]


def test_every_csrc_kernel_has_a_family():
    assert csrc_kernels() <= set(tracing.FAMILIES)


@pytest.mark.parametrize("wrapper", sorted(tracing.WRAPPERS))
def test_every_wrapper_launches_through_the_registry(wrapper):
    """Each registered wrapper exists in its module and counts its launch
    through tracing.launch under its own name, once; its kernels are the
    registry's."""
    module, fn = wrapper.split(".")
    sites = [f for name, f in launch_sites() if name == wrapper]
    assert [f.stem for f in sites] == [module]
    assert f"\ndef {fn}(" in sites[0].read_text()
    w = tracing.WRAPPERS[wrapper]
    assert set(w.kernels) <= set(tracing.FAMILIES) and w.per_call >= 1


def test_every_launch_site_is_registered():
    names = [name for name, _ in launch_sites()]
    assert sorted(names) == sorted(tracing.WRAPPERS)


@pytest.mark.parametrize("name,family", [
    ("void k_behz<8, 3, false>(BehzIO)", "behz"),
    ("void k_salsa20_lanes(unsigned int*, long long, unsigned int, "
     "unsigned long const*, unsigned long, unsigned long)", "draws"),
    ("void k_salsa20(uint4*, long long, unsigned int, unsigned long const*,"
     " unsigned long, unsigned long)", "draws"),
    ("void k_salsa20_draws(int*, int*, int, unsigned int, "
     "unsigned long long const*)", "draws"),
    ("void k_op_cluster<3, 2, EncryptTransform>(EncryptTransform)",
     "whole_op"),
    ("void k_stage_inv_block<3, 2>(StageIO, Twiddles)", "transform"),
    ("void k_stage_fwd_block<3, 2>(StageIO, Twiddles)", "transform"),
    ("void k_stage_fwd_block_ks<3, 2>(StageIO, Twiddles)", "keyswitch"),
    ("void k_stage_inv_block_ks<3, 1>(StageIO, Twiddles)", "keyswitch"),
    ("void at::native::elementwise_kernel<128, 2>(int, Fn)", None),
    ("Memcpy DtoD (Device -> Device)", None),
    ("void kernel_k_behz(int)", None),
    ("ntt.launch.fused_ops.encrypt_fused", None),
])
def test_family_of(name, family):
    assert tracing.family_of(name) == family


@pytest.mark.parametrize("kernel", ["k_stage_fwd_block_ks",
                                    "k_stage_inv_block_ks"])
def test_keyswitch_kernels_match_port_kernel(kernel):
    """The key switch's own symbols still match the benchmark's frozen
    list of the library's kernels (portbench/harness/trace.py PORT_KERNEL),
    so its glue_share does not count them as glue; the registry gives them
    to the key switch's wrappers alone."""
    from portbench.harness.trace import PORT_KERNEL
    assert PORT_KERNEL.search(f"void {kernel}<3, 2>(StageIO, Twiddles)")
    ks = [w for w, v in tracing.WRAPPERS.items() if kernel in v.kernels]
    assert sorted(ks) == sorted(
        ["fused_ops.keyswitch_fused", "fused_ops.keyswitch_front"]
        + (["coef_kernels.local_keyswitch_acc"] if "inv" in kernel else []))


# --- counting and spans -------------------------------------------------------

def test_registry_counts_through_launch():
    tracing.reset()
    for _ in range(3):
        with tracing.launch("ntt_stage.ntt_forward"):
            pass
    with tracing.launch("fused_ops.encrypt_fused"):
        pass
    c = tracing.counts()
    assert c["ntt_stage.ntt_forward"] == 3
    assert c["fused_ops.encrypt_fused"] == 1
    assert sum(c.values()) == 4
    assert set(c) == set(tracing.WRAPPERS)
    with pytest.raises(KeyError):
        tracing.launch("ntt_stage.no_such_wrapper")
    tracing.reset()
    assert not any(tracing.counts().values())


def test_launch_spans_only_under_the_profiler():
    tracing.reset()
    with tracing.launch("behz_kernels.rns_to_bsk"):
        pass
    assert tracing.snapshot() == {}
    with _cpu_profile():
        with tracing.launch("behz_kernels.rns_to_bsk"):
            pass
    snap = tracing.snapshot()
    assert list(snap) == ["ntt.launch.behz_kernels.rns_to_bsk"]
    assert snap["ntt.launch.behz_kernels.rns_to_bsk"].count == 1
    assert tracing.counts()["behz_kernels.rns_to_bsk"] == 2


def test_profiler_off_records_no_span(cpu_ctx):
    sk, pk = cpu_ctx.keygen(nonce=1)
    tracing.reset()
    assert tracing.span("ntt.mul") is tracing.span("ntt.draws")
    m = torch.zeros((2, cpu_ctx.params.n), dtype=torch.int64)
    cpu_ctx.decrypt_batch(sk, cpu_ctx.encrypt_batch(pk, m, [3, 4]))
    assert tracing.snapshot() == {}
    # the CPU runs the plain versions: no kernel launched, none counted
    assert not any(tracing.counts().values())


def test_op_spans_nest_under_the_profiler(cpu_ctx):
    """encrypt_batch holds the draws; mul(rlk=) holds relinearize, which
    counts once among the outer op spans."""
    sk, pk = cpu_ctx.keygen(nonce=1)
    rlk = cpu_ctx.relin_keygen(sk, nonce=2)
    rng = np.random.default_rng(0)
    m = torch.from_numpy(rng.integers(0, cpu_ctx.params.t,
                                      (2, cpu_ctx.params.n)))
    with _cpu_profile() as prof:
        ct = cpu_ctx.encrypt_batch(pk, m, [5, 6])
        cpu_ctx.mul(ct[0], ct[1], rlk=rlk)
    events = {e.name: e for e in prof.events() if e.name.startswith("ntt.")}
    assert set(events) == {"ntt.encrypt_batch", "ntt.draws", "ntt.mul",
                           "ntt.relinearize"}
    assert all(e.device_type == torch.autograd.DeviceType.CPU
               for e in events.values())
    assert events["ntt.draws"].cpu_parent.name == "ntt.encrypt_batch"
    assert events["ntt.relinearize"].cpu_parent.name == "ntt.mul"
    snap = tracing.snapshot()
    assert set(snap) == set(events)
    for name in ("ntt.encrypt_batch", "ntt.draws", "ntt.mul"):
        assert snap[name].count == snap[name].outer_count == 1
        assert snap[name].ns == snap[name].outer_ns > 0
    rel = snap["ntt.relinearize"]
    assert rel.count == 1 and rel.outer_count == 0 and rel.outer_ns == 0
    assert 0 < rel.ns < snap["ntt.mul"].ns
    assert snap["ntt.draws"].ns < snap["ntt.encrypt_batch"].ns


def test_totals_restart_when_tracing_comes_on(cpu_ctx):
    sk, pk = cpu_ctx.keygen(nonce=1)
    m = torch.zeros(cpu_ctx.params.n, dtype=torch.int64)
    for _ in range(2):
        with _cpu_profile():
            cpu_ctx.encrypt(pk, m, nonce=7)
            cpu_ctx.encrypt(pk, m, nonce=8)
        cpu_ctx.encrypt(pk, m, nonce=9)        # off: not counted
        snap = tracing.snapshot()
        assert snap["ntt.encrypt"].outer_count == 2
        assert snap["ntt.draws"].count == 2


# --- on the card --------------------------------------------------------------

@pytest.mark.gpu
def test_cuda_spans_have_no_device_copy_and_counts_match_kernels():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    dev = torch.device("cuda", torch.cuda.current_device())
    ctx = BFVContext.build(get_bfv_params(SET), device=dev)
    sk, pk = ctx.keygen(nonce=1)
    m = torch.zeros((4, ctx.params.n), dtype=torch.int64, device=dev)
    ctx.encrypt_batch(pk, m, [1, 2, 3, 4])
    torch.cuda.synchronize()
    tracing.reset()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        ctx.encrypt_batch(pk, m, [5, 6, 7, 8])
        torch.cuda.synchronize()
    cuda_events = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
    assert not [e.name for e in cuda_events if e.name.startswith("ntt.")]
    host = {e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CPU}
    assert {"ntt.encrypt_batch", "ntt.draws",
            "ntt.launch.fused_ops.encrypt_fused",
            "ntt.launch.salsa20.encrypt_draws_batch"} <= host
    counts = tracing.counts()
    assert counts["fused_ops.encrypt_fused"] == 1
    assert counts["salsa20.encrypt_draws_batch"] == 1
    launched = sum(c * tracing.WRAPPERS[w].per_call
                   for w, c in counts.items())
    kernels = [e.name for e in cuda_events
               if tracing.family_of(e.name) is not None]
    assert len(kernels) == launched == 3


@pytest.mark.gpu
def test_cuda_keyswitch_runs_as_its_own_kernels():
    """On the card the key switch's two stage launches are the `_ks`
    kernels (family keyswitch), then its tail; a plain forward transform
    stays k_stage_fwd_block (family transform)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    from ntt_cuda_tpu_torch.ops import fused_ops, ntt_stage
    dev = torch.device("cuda", torch.cuda.current_device())
    p = get_bfv_params(SET)
    ctx = BFVContext.build(p, device=dev, fusion="stage")
    tb, k = ctx.tables_full, p.r - 1
    g = torch.Generator(device=dev).manual_seed(5)
    q = torch.tensor(p.q, device=dev).reshape(-1, 1)
    c2 = torch.randint(0, 1 << 40, (k, p.n), generator=g, device=dev) % q[:k]
    ksk = torch.randint(0, 1 << 40, (2, k, p.r, p.n), generator=g,
                        device=dev) % q
    x = torch.randint(0, 1 << 40, (p.r, p.n), generator=g, device=dev) % q
    for run in range(2):                     # the first call builds
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            fused_ops.keyswitch_fused(c2, ksk, tb, ctx.tail_consts)
            ntt_stage.ntt_forward(x, tb)
            torch.cuda.synchronize()
    events = sorted((e.time_range.start, e.name) for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    fams = [tracing.family_of(n) for _, n in events]
    assert [f for f in fams if f is not None] == [
        "keyswitch", "keyswitch", "tail", "transform"]
