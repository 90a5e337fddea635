"""The traffic makers repeat from the seed: messages, slice orders,
nonces and the sample of requests the check redoes."""

import numpy as np
import torch

from portbench.harness.cells import CellBase, Reservoir

CFG = {"n": 64, "t": 1024, "q": [97, 193, 257]}


def cell(seed, J=4):
    return CellBase(None, CFG, {"J": J}, seed, torch.device("cpu"))


def test_inputs_repeat_from_the_seed():
    seed = 2 ** 31 + 12345
    a, b, c = cell(seed), cell(seed), cell(seed + 1)
    assert torch.equal(a.messages(8), b.messages(8))
    assert not torch.equal(cell(seed).messages(8), c.messages(8))
    assert a.starts(32) == b.starts(32)
    assert sorted(cell(seed).starts(32)) == list(range(32 - 4 + 1))
    m = cell(seed).messages(16)
    assert int(m.min()) >= 0 and int(m.max()) < CFG["t"]


def test_nonces_distinct_and_below_2_63():
    for seed in (0, 7, 2 ** 31 + 3, 2 ** 33 - 1):
        c = cell(seed)
        used = np.concatenate(
            [c.nonces(1, 2048)]
            + [c.request_nonces(i, True) for i in range(5)]
            + [c.request_nonces(i, False) for i in range(100000)])
        assert len(np.unique(used)) == len(used)
        assert int(used.max()) < 2 ** 63 and int(used.min()) > 0


def test_reservoir_is_seeded_and_uniform_in_size():
    picks = []
    for _ in range(2):
        r = Reservoir(3, 99)
        for i in range(1000):
            r.slot(i)
        picks.append(list(r.index))
    assert picks[0] == picks[1] and None not in picks[0]
    r = Reservoir(3, 99)
    r.slot(0)
    assert r.index == [0, None, None]
