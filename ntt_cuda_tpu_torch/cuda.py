"""Build, load and call the hand-written CUDA kernels in `csrc/`.

The kernels are compiled with `nvcc` for `sm_90a` (Hopper) into one shared
library with a plain C interface, loaded with ctypes (no PyTorch headers,
so a build takes seconds).  The library goes to `build/cuda-<hash>/` at
the root of the checkout, keyed by a hash of the sources and flags, and is
built at the first kernel call of a process.  Nothing here runs at import:
the package imports where there is no CUDA at all.

Each `extern "C"` launcher takes device pointers and the stream as
`c_void_p` (a pointer passed as a plain int would be cut to 32 bits),
launches on PyTorch's current stream, allocates nothing and returns
`cudaGetLastError()`; `launch` raises when that is not 0.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("salsa20.cu", "decrypt_tail.cu", "fused_ops.cu")
HEADERS = ("modarith.cuh", "ntt_block.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
MAX_N = 16384   # one u64 polynomial per block in shared memory: 128 KB

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_U32 = ctypes.c_uint32
_U64 = ctypes.c_uint64

# argtypes of every launcher; the last argument is always the stream.
SIGNATURES = {
    # bw, lanes, nb, key word, nonce, counter0
    "ntt_salsa20": (_P, _P, _L, _U32, _U64, _U64, _P),
    # x, c0, out, per_mod, glob, J, r-1, n, pow2, t, neg_t, nu_t, inv_gt
    "ntt_decrypt_tail": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _U64, _U64,
                         _U64, _U64, _P),
    # x, y, out, 4 tables, consts, blocks, r, log n
    "ntt_half_polymul": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    # s_b, a, e_d, sk, pk0, 4 tables, consts, r, log n
    "ntt_keygen_fused": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P),
    # u_b, pk, e_d, scratch, 4 tables, consts, J, r, log n
    "ntt_encrypt_transform": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                              _I, _P),
    # scratch, m, ct, per_mod, q_last, half, fix_th, J, r, n
    "ntt_encrypt_tail": (_P, _P, _P, _P, _U64, _U64, _U64, _I, _I, _I, _P),
}


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare argtypes/restype of every launcher of a loaded library."""
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.ntt_error_string.argtypes = [ctypes.c_int]
    lib.ntt_error_string.restype = ctypes.c_char_p
    return lib


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels of "
                       "ntt_cuda_tpu_torch are built from csrc/ at first use")


def build() -> Path:
    """Compile csrc/*.cu into one shared library (skipped when the hashed
    build exists) and return its path."""
    out_dir = CSRC.parents[1] / "build" / f"cuda-{source_hash()}"
    lib = out_dir / "libntt_cuda_tpu_torch.so"
    if lib.is_file():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".tmp-{os.getpid()}.so"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(CSRC / s) for s in SOURCES]]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                           f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    os.replace(tmp, lib)   # atomic: a concurrent build never sees half a file
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The kernels' library, built if needed and loaded once per process."""
    return bind(ctypes.CDLL(str(build())))


def require(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
            device: torch.device) -> None:
    """Raise unless `t` is a contiguous tensor of the given dtype and
    shape on `device` (what the launcher's raw pointer arithmetic needs)."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def launch(fn_name: str, device: torch.device, *args) -> None:
    """Call one launcher on `device`'s current stream; raise on a CUDA
    error (a refused launch never runs, and synchronize() would not
    report it)."""
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn_name)(*args, stream)
    if rc != 0:
        msg = lib.ntt_error_string(rc).decode()
        raise RuntimeError(f"{fn_name}: CUDA error {rc} ({msg})")
