"""The package's one instrumentation: host spans and the launch registry.

Tracing is on exactly while torch.profiler records: between a profile's
`start_trace()` and `stop_trace()` (or inside `with profile(...)`, or
`utils/profiling.trace`), the state torch keeps in
`torch.autograd.profiler._is_profiler_enabled`.  There is no other
switch.  Off, a span costs one check of that flag and a launch one count.

Spans.  `span(name)` is a context manager (`traced(name)` the decorator
form).  While tracing is on it records a host-only profiler event of that
name on the profiler's own clock, so that it sits in the exported trace
(Perfetto, chrome://tracing) beside the kernels it issued, and adds its
`time.perf_counter_ns()` duration to the per-name totals of `snapshot()`.
The event is a function-scope record (`_RecordFunctionFast`), which gets
no device-side copy on the card, unlike `torch.profiler.record_function`'s
user annotation.  The names, each read by a per-layer metric of
portbench/:

* `ntt.<op>`: every public `BFVContext` method that launches the
  library's kernels (models/bfv.py), nesting kept (`ntt.relinearize`
  inside `ntt.mul`);
* `ntt.draws`: the draw functions of ops/sampling.py that those ops call
  (the keystream launch and the converters);
* `ntt.launch.<wrapper>`: the host work of one kernel wrapper, from its
  checks to its launches' return (`launch` below).

A span counts as outer where no span of its kind (op, draws, launch) is
open around it, so that an op inside another (mul's relinearize) counts
once among the outer ones.  The totals restart when the first span after
tracing came on sees it on, and are kept for one thread.

Launch registry.  Every kernel wrapper of the package runs its CUDA
launch inside `with launch("<module>.<wrapper>"):`, which adds 1 to the
wrapper's count whether tracing is on or not (the CPU's plain versions
launch nothing and count nothing) and, while tracing is on, opens the
wrapper's `ntt.launch.` span.  `WRAPPERS` maps each wrapper to the
`csrc/` kernels it launches and to how many launches one call makes;
`FAMILIES` maps each kernel to its family; `family_of` names the family
of a profiler event's name (None: not a kernel of the library).  A CUDA
graph replays with no Python, so it counts nothing: a function given to
`utils/profiling.graphed` counts its launches at its eager calls alone
(graphed's two warm-up calls and the capture, once each).

Stage paths.  `stage_paths()` counts the stage transform's launches
(csrc/ntt_stage.cu, every `k_stage_*` launch, whichever wrapper made it)
since the last `reset()` by the path the launchers took: "engine", the
persistent, modulus-grouped launch of the grids wider than the card,
and "one", the kernel of OCC = 1, one polynomial a cluster.  The library
counts them as it launches (`ntt_stage_paths`), graph replays excepted.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import re
import time

import torch
from torch.autograd import profiler as _profiler

from .. import cuda

_RecordFunction = torch._C._profiler._RecordFunctionFast

# the family of each __global__ kernel of csrc/ (tests hold this equal to
# the sources)
FAMILIES = {
    "k_salsa20": "draws",
    "k_salsa20_lanes": "draws",
    "k_salsa20_draws": "draws",
    "k_stage_fwd_block": "transform",
    "k_stage_inv_block": "transform",
    "k_stage_fwd_block_ks": "keyswitch",
    "k_stage_inv_block_ks": "keyswitch",
    "k_cross_stage": "transform",
    "k_ntt30_cluster": "transform",
    "k_op_cluster": "whole_op",
    "k_encrypt_tail": "tail",
    "k_decrypt_tail": "tail",
    "k_decrypt_cluster": "tail",
    "k_behz": "behz",
}

Wrapper = collections.namedtuple("Wrapper", "kernels per_call")

_FWD, _INV = "k_stage_fwd_block", "k_stage_inv_block"
_FWD_KS, _INV_KS = "k_stage_fwd_block_ks", "k_stage_inv_block_ks"
_SALSA = ("k_salsa20", "k_salsa20_lanes")     # by the stream's size

# wrapper -> (the kernels it can launch, kernel launches per call)
WRAPPERS = {
    "salsa20.keystream_words": Wrapper(_SALSA, 1),
    "salsa20.keystream_words_batch": Wrapper(_SALSA, 1),
    "salsa20.encrypt_draws_batch": Wrapper(("k_salsa20_draws",), 1),
    "ntt_stage.ntt_transform_idx": Wrapper((_FWD, _INV), 1),
    "ntt_stage.ntt_forward": Wrapper((_FWD,), 1),
    "ntt_stage.ntt_inverse": Wrapper((_INV,), 1),
    "ntt_stage.ntt_inverse_mul": Wrapper((_INV,), 1),
    "ntt_stage.ntt_forward_ternary": Wrapper((_FWD,), 1),
    "ntt_stage.ntt_forward_addneg_gauss": Wrapper((_FWD,), 1),
    "ntt_stage.ntt_forward_addneg": Wrapper((_FWD,), 1),
    "fused_ops.half_polymul": Wrapper(("k_op_cluster",), 1),
    "fused_ops.keygen_fused": Wrapper(("k_op_cluster",), 1),
    "fused_ops.encrypt_fused": Wrapper(("k_op_cluster", "k_encrypt_tail"), 2),
    "fused_ops.encrypt_front": Wrapper(("k_op_cluster",), 1),
    "fused_ops.keyswitch_front": Wrapper((_FWD_KS, _INV_KS), 2),
    "fused_ops.keyswitch_fused": Wrapper(
        (_FWD_KS, _INV_KS, "k_encrypt_tail"), 3),
    "bfv_tail.decrypt_tail": Wrapper(("k_decrypt_tail",), 1),
    "bfv_tail.encrypt_fused": Wrapper((_INV, "k_encrypt_tail"), 2),
    "bfv_tail.encrypt_tail": Wrapper(("k_encrypt_tail",), 1),
    "bfv_tail.decrypt_fused": Wrapper(("k_decrypt_cluster",), 1),
    "bfv_tail.encrypt_tail_padded": Wrapper(("k_encrypt_tail",), 1),
    "bfv_tail.drop_last_padded": Wrapper(("k_encrypt_tail",), 1),
    "bfv_tail.decrypt_tail_partial": Wrapper(("k_decrypt_tail",), 1),
    "ntt30.ntt_forward": Wrapper(("k_ntt30_cluster",), 1),
    "ntt30.ntt_inverse": Wrapper(("k_ntt30_cluster",), 1),
    "behz_kernels.rns_to_bsk": Wrapper(("k_behz",), 1),
    "behz_kernels.fast_floor": Wrapper(("k_behz",), 1),
    "behz_kernels.bsk_to_q": Wrapper(("k_behz",), 1),
    "behz_kernels.scale_and_round": Wrapper(("k_behz",), 1),
    "behz_kernels.rns_to_bsk_rows": Wrapper(("k_behz",), 1),
    "behz_kernels.fast_floor_rows": Wrapper(("k_behz",), 1),
    "behz_kernels.bsk_to_q_rows": Wrapper(("k_behz",), 1),
    "coef_kernels.local_forward": Wrapper((_FWD,), 1),
    "coef_kernels.local_inverse_mul": Wrapper((_INV,), 1),
    "coef_kernels.local_keyswitch_acc": Wrapper((_INV_KS,), 1),
    "coef_kernels.cross_stage": Wrapper(("k_cross_stage",), 1),
}

Totals = collections.namedtuple("Totals", "count ns outer_count outer_ns")

_OFF = contextlib.nullcontext()
_LAUNCH_SPAN = {w: "ntt.launch." + w for w in WRAPPERS}
_counts = dict.fromkeys(WRAPPERS, 0)
_totals: dict[str, list[int]] = {}
_open = {"op": 0, "draws": 0, "launch": 0}
_seen_on = False


def _kind(name: str) -> str:
    if name.startswith("ntt.launch."):
        return "launch"
    return "draws" if name == "ntt.draws" else "op"


class _Span:
    """One span while tracing is on: the profiler event and the totals."""

    __slots__ = ("name", "kind", "rf", "t0")

    def __init__(self, name: str):
        global _seen_on
        if not _seen_on:
            _totals.clear()
            _seen_on = True
        self.name, self.kind = name, _kind(name)
        self.rf = _RecordFunction(name)

    def __enter__(self):
        self.rf.__enter__()
        _open[self.kind] += 1
        self.t0 = time.perf_counter_ns()

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        _open[self.kind] -= 1
        t = _totals.setdefault(self.name, [0, 0, 0, 0])
        t[0] += 1
        t[1] += dt
        if not _open[self.kind]:
            t[2] += 1
            t[3] += dt
        self.rf.__exit__(*exc)
        return False


def span(name: str):
    """A span of `name` while torch.profiler records; a shared no-op
    context otherwise."""
    global _seen_on
    if not _profiler._is_profiler_enabled:
        _seen_on = False
        return _OFF
    return _Span(name)


def traced(name: str):
    """Decorator: the whole call runs inside span(name) (off, the flag's
    check alone)."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            global _seen_on
            if not _profiler._is_profiler_enabled:
                _seen_on = False
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)
        return run
    return wrap


def launch(wrapper: str):
    """Count one call of a registered kernel wrapper (KeyError for a name
    outside WRAPPERS) and, while tracing is on, span its host work."""
    global _seen_on
    _counts[wrapper] += 1
    if not _profiler._is_profiler_enabled:
        _seen_on = False
        return _OFF
    return _Span(_LAUNCH_SPAN[wrapper])


def counts() -> dict[str, int]:
    """Calls of each registered wrapper since the last reset()."""
    return dict(_counts)


def reset() -> None:
    """Zero the launch counts, the stage paths and the span totals."""
    for w in _counts:
        _counts[w] = 0
    _paths_at_reset[:] = _stage_path_totals()
    _totals.clear()


STAGE_PATHS = ("engine", "one")
_paths_at_reset = [0, 0]


def _stage_path_totals() -> list[int]:
    """The loaded library's stage launches by path since it loaded."""
    lib = cuda.loaded()
    if lib is None:
        return [0, 0]
    out = (ctypes.c_longlong * 2)()
    lib.ntt_stage_paths(out)
    return list(out)


def stage_paths() -> dict[str, int]:
    """Stage transform launches of each path since the last reset()."""
    return {k: t - b for k, t, b in zip(STAGE_PATHS, _stage_path_totals(),
                                        _paths_at_reset)}


def snapshot() -> dict[str, Totals]:
    """name -> Totals(count, ns, outer_count, outer_ns) of the spans closed
    since tracing last came on."""
    return {k: Totals(*v) for k, v in _totals.items()}


_KERNEL_NAME = re.compile(r"\bk_\w+")


@functools.lru_cache(maxsize=4096)
def family_of(event_name: str):
    """The family of the library kernel a profiler event names (a demangled
    `void k_behz<8, 3, false>(BehzIO)`, say), None for any other event."""
    for m in _KERNEL_NAME.finditer(event_name):
        fam = FAMILIES.get(m.group())
        if fam is not None:
            return fam
    return None
