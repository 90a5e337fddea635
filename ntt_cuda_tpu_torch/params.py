"""Parameter registry: the single-modulus NTT families, the published BFV
RNS sets and their exact-int precompute.

PyTorch-side counterpart of `ntt_cuda_tpu/params.py` (the reference's
`BFV_Scheme/parameter.h` tables and the host precompute of
`BFV_Scheme/demo.cu:62-272`).  It is a copy, not an import: importing
anything under `ntt_cuda_tpu` imports jax, and this package must run
where jax is not installed.  `tests/test_torch_modmath.py` holds every
derived constant equal to the JAX package's for every published set.
"""

from __future__ import annotations

import dataclasses
import functools

from .utils import hostmath as hm

# Single-modulus NTT parameter families (parameter.h getParams /
# getParams30).  Tuples are (q, psi, psiinv, ninv, q_bit).
PARAMS_60BIT = {
    2048: (137438691329, 22157790, 88431458764, 137371582593, 37),
    4096: (33538049, 2386, 26102329, 33529861, 25),
    8192: (8796092858369, 1734247217, 5727406356888, 8795019116565, 43),
    16384: (281474976546817, 23720796222, 129310633907832, 281457796677643, 48),
    32768: (36028797017456641, 1155186985540, 31335194304461613, 36027697505828911, 55),
}

# Alternative n=4096 set kept commented in the reference (parameter.h:43-47).
PARAMS_60BIT_ALT4096 = (288230376135196673, 60193018759093, 236271020333049746, 288160007391023041, 58)

PARAMS_30BIT = {
    2048: (536608769, 284166, 208001377, 536346753, 29),
    4096: (33538049, 2386, 26102329, 33529861, 25),
    8192: (8716289, 1089, 8196033, 8715225, 24),
    16384: (13664257, 273, 8959348, 13663423, 24),
    32768: (19070977, 377, 16642842, 19070395, 25),
    65536: (13631489, 13, 12582913, 13631281, 24),
}


def get_params(n: int, family: str = "60bit"):
    """(q, psi, psiinv, ninv, q_bit) for a single-modulus NTT at size n
    (parameter.h getParams for the 60-bit family, getParams30)."""
    table = PARAMS_60BIT if family == "60bit" else PARAMS_30BIT
    return table[n]


# All published sets use t = 1024 and gamma = 2305843009213683713 (61-bit).
T_DEFAULT = 1024
GAMMA = 2305843009213683713

BFV_SETS: dict[str, tuple[int, list[int], list[int]]] = {
    # name: (n, q_array, psi_roots)
    "4k_3q": (
        4096,
        [68719403009, 68719230977, 137438822401],
        [24250113, 29008497, 8625844],
    ),
    "8k_3q": (
        8192,
        [274877562881, 274877202433, 274877153281],
        [71485851, 33872056, 22399294],
    ),
    "8k_4q": (
        8192,
        [8796092858369, 8796092792833, 17592186028033, 17592185438209],
        [1734247217, 304486499, 331339694, 9366611238],
    ),
    "16k_5q": (
        16384,
        [1125899904679937, 1125899903991809, 1125899903827969, 1125899903795201, 1125899903500289],
        [184459094098, 125929543876, 13806300337, 10351677219, 68423600398],
    ),
    "16k_9q": (
        16384,
        [281474976546817, 281474976317441, 281474975662081, 562949952798721, 562949952700417,
         562949952274433, 562949951979521, 562949951881217, 1125899904679937],
        [23720796222, 21741529212, 13412349256, 1196930505, 31695302805,
         6575376104, 394024808, 45092463253, 184459094098],
    ),
    "32k_9q": (
        32768,
        [36028797012606977, 36028797010444289, 36028797009985537, 36028797005856769, 36028797005529089,
         36028797005135873, 36028797003694081, 36028797003563009, 36028797001138177],
        [768741990072, 3911086673862, 5947090524825, 47595902954, 2691682578057,
         3903338373, 235185854118, 1769787302793, 3151164484090],
    ),
    "32k_11q": (
        32768,
        [36028797013327873, 36028797013000193, 36028797012606977, 36028797010444289, 36028797009985537,
         36028797005856769, 36028797005529089, 36028797005135873, 36028797003694081, 36028797003563009,
         36028797001138177],
        [1650884166641, 10316746886, 768741990072, 3911086673862, 5947090524825,
         47595902954, 2691682578057, 3903338373, 235185854118, 1769787302793,
         3151164484090],
    ),
    "32k_16q": (
        32768,
        [18014398506729473, 36028797017456641, 36028797014704129, 36028797014573057, 36028797014376449,
         36028797013327873, 36028797013000193, 36028797012606977, 36028797010444289, 36028797009985537,
         36028797005856769, 36028797005529089, 36028797005135873, 36028797003694081, 36028797003563009,
         36028797001138177],
        [58232959302, 1155186985540, 631260524634, 1526647220035, 455957817523,
         1650884166641, 10316746886, 768741990072, 3911086673862, 5947090524825,
         47595902954, 2691682578057, 3903338373, 235185854118, 1769787302793,
         3151164484090],
    ),
}


@dataclasses.dataclass(frozen=True)
class BFVParams:
    """All static parameters and exact-int precomputed constants for one
    BFV set (demo.cu:62-272).  Everything is a Python int or a tuple of
    ints; the device tensors are built from this by `ops.modmath`,
    `ops.ntt`, `ops.poly` and `ops.bfv_tail`."""

    name: str
    n: int
    q: tuple[int, ...]            # RNS moduli, q[-1] is the dropped modulus
    psi: tuple[int, ...]
    t: int = T_DEFAULT
    gamma: int = GAMMA

    @property
    def r(self) -> int:
        """Number of RNS moduli including the one dropped after encryption."""
        return len(self.q)

    @property
    def logn(self) -> int:
        return self.n.bit_length() - 1

    @functools.cached_property
    def psiinv(self) -> tuple[int, ...]:
        return tuple(hm.modinv(p, q) for p, q in zip(self.psi, self.q))

    @functools.cached_property
    def q_bits(self) -> tuple[int, ...]:
        return tuple(hm.q_bit_length(q) for q in self.q)

    @functools.cached_property
    def mu(self) -> tuple[int, ...]:
        """Barrett mu per modulus (demo.cu:156-165); kept for API parity."""
        return tuple(hm.mu_barrett(q, b) for q, b in zip(self.q, self.q_bits))

    @functools.cached_property
    def inv_q_last_mod_q(self) -> tuple[int, ...]:
        """(q_last mod q_i)^-1 mod q_i for i < r-1 (demo.cu:73-79)."""
        qlast = self.q[-1]
        return tuple(hm.modinv(qlast % qi, qi) for qi in self.q[:-1])

    @functools.cached_property
    def qi_div_t(self) -> tuple[int, ...]:
        """floor(q_i / t) per modulus (demo.cu:84-88)."""
        return tuple(qi // self.t for qi in self.q)

    # The constants below are over the decryption base q[0:r-1] (the last
    # modulus is dropped before decryption; demo.cu:218).
    @functools.cached_property
    def punctured_q(self) -> tuple[int, ...]:
        """prod_{j != i} q_j mod q_i over the dropped base (demo.cu:228-243)."""
        qs = self.q[:-1]
        out = []
        for i, qi in enumerate(qs):
            v = 1
            for j, qj in enumerate(qs):
                if j != i:
                    v = (v * qj) % qi
            out.append(v)
        return tuple(out)

    @functools.cached_property
    def inv_punctured_q(self) -> tuple[int, ...]:
        return tuple(hm.modinv(p, qi) for p, qi in zip(self.punctured_q, self.q[:-1]))

    @functools.cached_property
    def base_change_matrix(self) -> tuple[tuple[int, ...], tuple[int, ...]]:
        """Row 0: prod_{k != j} q_k mod t; row 1: same mod gamma (demo.cu:247-264)."""
        qs = self.q[:-1]
        rows = []
        for base in (self.t, self.gamma):
            row = []
            for j in range(len(qs)):
                v = 1
                for k, qk in enumerate(qs):
                    if k != j:
                        v = (v * qk) % base
                row.append(v)
            rows.append(tuple(row))
        return tuple(rows)  # type: ignore[return-value]

    @functools.cached_property
    def neg_inv_q_mod_t_gamma(self) -> tuple[int, int]:
        """(-prod q_i)^-1 mod t and mod gamma (demo.cu:103-112)."""
        qs = self.q[:-1]
        mult_t = 1
        mult_g = 1
        for qi in qs:
            mult_t = (mult_t * qi) % self.t
            mult_g = (mult_g * qi) % self.gamma
        return (self.t - hm.modinv(mult_t, self.t),
                self.gamma - hm.modinv(mult_g, self.gamma))

    @functools.cached_property
    def prod_t_gamma_mod_q(self) -> tuple[int, ...]:
        """t*gamma mod q_i over the dropped base (demo.cu:114-123)."""
        tg = self.t * self.gamma
        return tuple(tg % qi for qi in self.q[:-1])

    @property
    def gamma_bits(self) -> int:
        return 61  # output_base_bit_lengths[1] (demo.cu:100)

    @functools.cached_property
    def mu_gamma(self) -> int:
        return hm.mu_barrett(self.gamma, self.gamma_bits)

    @property
    def gamma_div_2(self) -> int:
        return self.gamma >> 1

    @property
    def half_last_modulus(self) -> int:
        """floor(q_last / 2) (bfv_encryption.cuh:113-114)."""
        return self.q[-1] >> 1

    @functools.cached_property
    def half_mod_q(self) -> tuple[int, ...]:
        """half_last_modulus mod q_i for i < r-1 (bfv_encryption.cuh:140)."""
        return tuple(self.half_last_modulus % qi for qi in self.q[:-1])

    def psi_tables(self, i: int) -> tuple[list[int], list[int]]:
        """Bit-reversed psi / psiinv power tables for modulus i."""
        return hm.psi_tables(self.psi[i], self.psiinv[i], self.q[i], self.n)


def get_bfv_params(name: str) -> BFVParams:
    n, q, psi = BFV_SETS[name]
    return BFVParams(name=name, n=n, q=tuple(q), psi=tuple(psi))
