"""What every op's cell shares: inputs from the seed, nonces that never
repeat within a run, pools on the card, the seeded order of the slices a
request takes, and the seeded sample of requests whose answers are kept
for the check, kept in host memory.

Nonces of one seed: the set-up's pool encryptions at root + 1 + p, the
warm-up's at root + 2^21 + ..., the window's at root + 2^22 + i J + j, the
keys' at root + 7 (keygen) and root + 11 (relinearization); root =
(seed mod 2^24) 2^36, so every nonce is below 2^63 as the API asks.
"""

from __future__ import annotations

import contextlib
import random

import numpy as np
import torch

NONCE_POOL, NONCE_WARM, NONCE_WINDOW = 1, 1 << 21, 1 << 22
NONCE_KEYGEN, NONCE_RELIN = 7, 11


class CellBase:
    """Set-up state of one cell: the system, the configuration and traffic,
    the seed's generators and the request plan.  `span(name)` is the
    context the op's calls into the library run under (`run_cell` gives it
    the profiler's record_function in a traced run)."""

    def __init__(self, system, config: dict, traffic: dict, seed: int,
                 device):
        self.system, self.config, self.traffic = system, config, traffic
        self.device, self.seed = device, seed
        self.n, self.t = int(config["n"]), int(config["t"])
        self.r = len(config["q"])
        self.k = self.r - 1
        self.J = int(traffic["J"])
        self.root = (seed % (1 << 24)) << 36
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(seed)
        self.rng = random.Random(seed)
        self.span = lambda name: contextlib.nullcontext()

    def nonce(self, offset: int) -> int:
        return self.root + offset

    def nonces(self, offset: int, count: int) -> np.ndarray:
        return (np.uint64(self.root + offset)
                + np.arange(count, dtype=np.uint64))

    def request_nonces(self, i: int, warm: bool) -> np.ndarray:
        base = NONCE_WARM if warm else NONCE_WINDOW
        return self.nonces(base + i * self.J, self.J)

    def messages(self, count: int) -> torch.Tensor:
        """(count, n) seeded messages in [0, t) on the card."""
        return torch.randint(0, self.t, (count, self.n), generator=self.gen,
                             device=self.device, dtype=torch.int64)

    def encrypt_pool(self, pk, msgs: torch.Tensor) -> torch.Tensor:
        """The pool's ciphertexts, J at a time, pool nonces root + 1 + p."""
        out = torch.empty((msgs.shape[0], 2, self.k, self.n),
                          dtype=torch.int64, device=self.device)
        for p in range(0, msgs.shape[0], self.J):
            m = msgs[p:p + self.J]
            out[p:p + m.shape[0]] = self.system.encrypt_batch(
                pk, m, self.nonces(NONCE_POOL + p, m.shape[0]))
        return out

    def kept(self, *shape: int) -> torch.Tensor:
        """A host buffer for the sampled answers (pinned where the cell
        runs on the card), so that the check's copies take no card memory
        from the peak: int64 of `shape`."""
        return torch.empty(shape, dtype=torch.int64,
                           pin_memory=self.device.type == "cuda")

    def starts(self, pool: int) -> list[int]:
        """Every start of a J-slice of a pool, in a seeded order."""
        s = list(range(pool - self.J + 1))
        self.rng.shuffle(s)
        return s


class Reservoir:
    """A seeded uniform sample of `size` of the window's requests (Algorithm
    R): `slot(i)` says where request i's answers go, or None."""

    def __init__(self, size: int, seed: int):
        self.size, self.rng = size, random.Random(seed ^ 0x5EED)
        self.index: list[int | None] = [None] * size

    def slot(self, i: int):
        j = i if i < self.size else self.rng.randrange(i + 1)
        if j < self.size:
            self.index[j] = i
            return j
        return None
