"""Key / ciphertext serialization (.npz).

A copy of `ntt_cuda_tpu/utils/serialize.py` (importing that package imports
jax): the same FORMAT_VERSION, kinds and keys, so a file written by either
package loads in the other.  Keys and ciphertexts round-trip through .npz
archives carrying the parameter identity (n, t, moduli) that rejects
mismatched loads.  `save_*` take the port's int64 tensors (any device,
through `convert.to_numpy`) or uint64 arrays; `load_*` return numpy uint64
arrays, as the JAX package's do (`convert.to_torch` carries them back).
"""

from __future__ import annotations

import numpy as np
import torch

from ..convert import to_numpy

FORMAT_VERSION = 1


def _u64(x) -> np.ndarray:
    return to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(
        x, np.uint64)


def _params_meta(params) -> dict:
    return {
        "format_version": np.int64(FORMAT_VERSION),
        "n": np.int64(params.n),
        "t": np.int64(params.t),
        "q": np.asarray(params.q, dtype=np.uint64),
    }


def _check_meta(data, params, path) -> None:
    if int(data["format_version"]) != FORMAT_VERSION:
        raise ValueError(f"{path}: unsupported format version "
                         f"{int(data['format_version'])}")
    if int(data["n"]) != params.n or int(data["t"]) != params.t or \
            not np.array_equal(data["q"], np.asarray(params.q, np.uint64)):
        raise ValueError(f"{path}: parameter mismatch (file has n={int(data['n'])}, "
                         f"t={int(data['t'])}, r={data['q'].size}; expected "
                         f"n={params.n}, t={params.t}, r={params.r})")


def save_keypair(path, params, sk, pk) -> None:
    """sk (r, n) and pk (2, r, n), both NTT domain."""
    np.savez(path, kind="keypair", sk=_u64(sk), pk=_u64(pk),
             **_params_meta(params))


def load_keypair(path, params):
    with np.load(path, allow_pickle=False) as data:
        if str(data["kind"]) != "keypair":
            raise ValueError(f"{path}: not a keypair file")
        _check_meta(data, params, path)
        return data["sk"], data["pk"]


def save_ciphertext(path, params, ct) -> None:
    """ct in either layout: (2, r-1, n) coefficient domain with the last
    modulus dropped (single-card pipelines), or (2, r, n) with the
    reference's padding-in-place slot (the sharded pipelines,
    bfv_encryption.cuh:216-222).  The layout is recorded and checked on
    load."""
    ct = _u64(ct)
    if ct.shape == (2, params.r - 1, params.n):
        layout = "dropped"
    elif ct.shape == (2, params.r, params.n):
        layout = "padded"
    else:
        raise ValueError(f"ciphertext shape {ct.shape} matches neither "
                         f"(2, {params.r - 1}, {params.n}) nor "
                         f"(2, {params.r}, {params.n})")
    np.savez(path, kind="ciphertext", ct=ct, layout=layout,
             **_params_meta(params))


def load_ciphertext(path, params, layout: str | None = None):
    """Load a ciphertext; `layout` ("dropped" | "padded") converts to the
    requested layout if it differs from the stored one."""
    with np.load(path, allow_pickle=False) as data:
        if str(data["kind"]) != "ciphertext":
            raise ValueError(f"{path}: not a ciphertext file")
        _check_meta(data, params, path)
        ct = data["ct"]
        stored = str(data["layout"]) if "layout" in data else "dropped"
    if layout is None or layout == stored:
        return ct
    if layout == "dropped":
        return drop_padding(ct)
    if layout == "padded":
        return pad_ciphertext(ct, params)
    raise ValueError(f"unknown layout {layout!r}")


def pad_ciphertext(ct, params) -> np.ndarray:
    """(2, r-1, n) -> (2, r, n): append a zero slot for the dropped
    modulus.  The padded slot is never consumed, so zeros are as valid as
    the reference's in-place garbage."""
    ct = _u64(ct)
    pad = np.zeros((2, 1, params.n), np.uint64)
    return np.concatenate([ct, pad], axis=1)


def drop_padding(ct) -> np.ndarray:
    """(2, r, n) -> (2, r-1, n): discard the dropped-modulus slot."""
    return _u64(ct)[:, :-1]


def save_relin_keys(path, params, rlk) -> None:
    """rlk (2, r-1, r, n) NTT domain (BFVContext.relin_keygen)."""
    rlk = _u64(rlk)
    want = (2, params.r - 1, params.r, params.n)
    if rlk.shape != want:
        raise ValueError(f"rlk: expected shape {want}, got {rlk.shape}")
    np.savez(path, kind="relin_keys", rlk=rlk, **_params_meta(params))


def load_relin_keys(path, params):
    with np.load(path, allow_pickle=False) as data:
        if str(data["kind"]) != "relin_keys":
            raise ValueError(f"{path}: not a relin-keys file")
        _check_meta(data, params, path)
        return data["rlk"]


def save_galois_keys(path, params, gks: dict) -> None:
    """gks: {galois element g: (2, r-1, r, n)} (BFVContext.galois_keygen,
    the port's or the JAX package's)."""
    want = (2, params.r - 1, params.r, params.n)
    elts = sorted(int(g) for g in gks)
    stack = []
    for g in elts:
        k = _u64(gks[g])
        if k.shape != want:
            raise ValueError(f"gks[{g}]: expected shape {want}, got {k.shape}")
        stack.append(k)
    np.savez(path, kind="galois_keys",
             elts=np.asarray(elts, np.int64),
             keys=np.stack(stack) if stack else
             np.zeros((0,) + want, np.uint64),
             **_params_meta(params))


def load_galois_keys(path, params) -> dict:
    with np.load(path, allow_pickle=False) as data:
        if str(data["kind"]) != "galois_keys":
            raise ValueError(f"{path}: not a galois-keys file")
        _check_meta(data, params, path)
        return {int(g): data["keys"][i]
                for i, g in enumerate(data["elts"])}
