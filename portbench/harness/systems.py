"""The system under test behind one interface: the library's BFVContext
(`Program`), or the plain reference put in its place (`Reference`: the
control, with its products through float64, or a test's stand-in)."""

from __future__ import annotations

import numpy as np

from ..reference.bfv_ref import RefContext


class Program:
    """ntt_cuda_tpu_torch's BFVContext over a configuration's parameters,
    on its stated schedule, through the public eager API."""

    def __init__(self, config: dict, device):
        from ntt_cuda_tpu_torch import BFVContext
        from ntt_cuda_tpu_torch.params import BFVParams
        params = BFVParams(name=config["name"], n=int(config["n"]),
                           q=tuple(int(q) for q in config["q"]),
                           psi=tuple(int(p) for p in config["psi"]),
                           t=int(config["t"]), gamma=int(config["gamma"]))
        self.ctx = BFVContext.build(params, device=device,
                                    fusion=config["schedule"])

    def keygen(self, nonce: int):
        return self.ctx.keygen(nonce)

    def encrypt_batch(self, pk, m, nonces: np.ndarray):
        return self.ctx.encrypt_batch(pk, m, nonces)

    def decrypt_batch(self, sk, cts):
        return self.ctx.decrypt_batch(sk, cts)

    def relin_keygen(self, sk, nonce: int):
        return self.ctx.relin_keygen(sk, nonce)

    def mul(self, a, b, rlk):
        return self.ctx.mul(a, b, rlk=rlk)


class Reference:
    """The plain reference in the program's place."""

    def __init__(self, config: dict, device, fp64: bool = False):
        self.ref = RefContext(config, device, fp64=fp64)

    def keygen(self, nonce: int):
        return self.ref.keygen(nonce)

    def encrypt_batch(self, pk, m, nonces: np.ndarray):
        return self.ref.encrypt(pk, m, [int(v) for v in nonces])

    def decrypt_batch(self, sk, cts):
        return self.ref.decrypt(sk, cts)

    def relin_keygen(self, sk, nonce: int):
        return self.ref.relin_keygen(sk, nonce)

    def mul(self, a, b, rlk):
        return self.ref.relinearize(self.ref.mul(a, b), rlk)
