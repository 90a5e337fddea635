"""A run driven to its end on the CPU (the chip's look skipped) with the
timed path broken underneath: `correct` comes out false for each fault a
cell can have, and true for the library as it is."""

import time

import pytest
import torch

from ntt_cuda_tpu_torch.params import BFV_SETS, GAMMA
from portbench.harness import manifest, runner
from portbench.harness.systems import Program

N, Q, PSI = BFV_SETS["4k_3q"]
SMALL = dict(name="4k_3q", n=N, q=Q, psi=PSI, t=1024, gamma=GAMMA,
             schedule="op")
TRAFFIC = {
    "16k_5q.client": {"op": "client", "J": 4, "msg_pool": 8,
                      "answer_pool": 6, "check_requests": 2},
    "32k_9q.mulrelin": {"op": "mulrelin", "J": 2, "ct_pool": 4,
                        "check_requests": 2},
}


class Broken(Program):
    """The library with one fault in the op the window times."""

    fault = None

    def _break(self, out, given=None):
        if self.fault == "half_batch":         # half of the batch left out
            h = out.shape[0] // 2
            out = torch.cat([out[:h], out[:out.shape[0] - h]])
        elif self.fault == "altered":            # an answer altered
            out = out.clone()
            out.view(-1)[7] += 1
        elif self.fault == "unchanged":       # the input passed through
            out = given
        return out

    def decrypt_batch(self, sk, cts):
        return self._break(super().decrypt_batch(sk, cts), cts[:, 0, 0])

    def mul(self, a, b, rlk):
        return self._break(super().mul(a, b, rlk), a)


def run(workload, make_system):
    spec = manifest.cell(manifest.load_manifest(), workload)
    spec["config"], spec["traffic"] = SMALL, TRAFFIC[workload]
    result, _ = runner.run_cell(spec, 2 ** 31 + 99, 0.5, False,
                                time.perf_counter(), torch.device("cpu"),
                                make_system=make_system)
    return result


@pytest.mark.parametrize("workload", sorted(TRAFFIC))
def test_sound_run_is_correct(workload):
    r = run(workload, Program)
    assert r["correct"] and r["failed"] == 0
    assert all(c["value"] == 0 for c in r["checks"].values())


@pytest.mark.parametrize("fault", ["half_batch", "altered", "unchanged"])
@pytest.mark.parametrize("workload", sorted(TRAFFIC))
def test_fault_is_not_correct(workload, fault):
    system = type("B", (Broken,), {"fault": fault})
    r = run(workload, system)
    assert not r["correct"]
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


def test_broken_encryption_is_not_correct():
    class Enc(Broken):
        fault = "altered"
        calls = 0

        def encrypt_batch(self, pk, m, nonces):
            out = super().encrypt_batch(pk, m, nonces)
            Enc.calls += 1           # the pool's and the warm-up's pass
            return self._break(out) if Enc.calls > 5 else out

        def decrypt_batch(self, sk, cts):
            return Program.decrypt_batch(self, sk, cts)

    r = run("16k_5q.client", Enc)
    assert not r["correct"] and r["checks"]["ct_words_wrong"]["value"] > 0
