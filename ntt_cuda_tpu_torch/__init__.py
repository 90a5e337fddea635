"""PyTorch + CUDA port of ntt_cuda_tpu: NTT and BFV on an NVIDIA H100.

The JAX package `ntt_cuda_tpu` stays the reference; this package computes
the same integers for the same parameters, inputs and nonces.  It imports
torch and numpy, never jax.  The CUDA kernels (csrc/) are built with nvcc
at their first launch; on the CPU every op runs its plain tensor version.

    from ntt_cuda_tpu_torch import BFVContext, get_bfv_params
    ctx = BFVContext.build(get_bfv_params("16k_5q"), device="cuda")
    sk, pk = ctx.keygen(nonce=1)
    ct = ctx.encrypt(pk, m, nonce=1)
    assert (ctx.decrypt(sk, ct) == m).all()
"""

from .models.bfv import BFVContext
from .params import BFV_SETS, BFVParams, get_bfv_params

__all__ = ["BFVContext", "BFVParams", "BFV_SETS", "get_bfv_params"]
