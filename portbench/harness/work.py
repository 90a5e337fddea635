"""The least time a request can take on the card: the yardstick of the
`roofline_share` metrics.

A frozen copy of `Work` and of the device constants of `chip_smoke.py` at
commit a9c3f5d, with the per-primitive instruction counts that its SASS
probe logged there (sm_90a, integer multiplies on the FMA pipe; the
Salsa20 block counted by pipe).  A change to the library moves the
measured time and never these numbers.

The least time is the larger of two terms: the request's compulsory bytes
(each input read once per request, each output written once, no
intermediates) over the HBM bandwidth, and the algorithm's instructions on
the busier pipe over 132 SMs x 64 a clock at 1980 MHz.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
SMS, FMA_PER_CLOCK, ALU_PER_CLOCK = 132, 64, 64
CLOCK_HZ = 1.98e9                # the H100 SXM's boost clock

# SASS instructions per primitive (chip_smoke.py's probe at a9c3f5d)
MULTS = {
    "shoup": 10,       # x * w mod q with w's Shoup companion
    "mont": 15,        # a Montgomery product of two runtime operands
    "mod_nu": 9,       # x mod q by floor(2^64 / q)
    "mullo": 3,        # a 64-bit low product
    "mul32": 1,
    "shoup32": 3,
    "mul128": 4,       # a 64 x 64 -> 128-bit product
    "salsa20_block": {"fma": 319, "alu": 675},   # one 64-byte block
}


class Work:
    """Bytes a request must move and the primitives it must issue."""

    def __init__(self, nbytes: int, **prims):
        self.nbytes, self.prims = nbytes, prims

    def __add__(self, other: "Work") -> "Work":
        prims = dict(self.prims)
        for k, v in other.prims.items():
            prims[k] = prims.get(k, 0) + v
        return Work(self.nbytes + other.nbytes, **prims)

    def terms(self) -> dict:
        """Both terms in seconds, and the instruction counts by pipe."""
        pipes = {"fma": 0, "alu": 0}
        for k, v in self.prims.items():
            m = MULTS[k]
            for pipe, cnt in (m.items() if isinstance(m, dict)
                              else [("fma", m)]):
                pipes[pipe] += cnt * v
        clocks = max(pipes["fma"] / FMA_PER_CLOCK,
                     pipes["alu"] / ALU_PER_CLOCK)
        return {"bytes_s": self.nbytes / HBM_BYTES_PER_S,
                "ops_s": clocks / (SMS * CLOCK_HZ), **pipes}

    def least_s(self) -> float:
        t = self.terms()
        return max(t["bytes_s"], t["ops_s"])


def butterflies(polys: int, n: int) -> int:
    """(n/2) log2 n butterflies of each of `polys` transforms."""
    return polys * (n // 2) * (n.bit_length() - 1)


def transforms(polys: int, n: int, inverse: bool = False) -> Work:
    """`polys` transforms of length n, a Shoup product a butterfly (and
    one a coefficient for n^-1 in the inverse)."""
    return Work(0, shoup=butterflies(polys, n) + (polys * n if inverse
                                                   else 0))


def table_bytes(moduli: int, n: int) -> int:
    """The twiddle tables of both directions, with Shoup companions."""
    return 4 * moduli * n * 8
