"""Build, load and call the hand-written CUDA kernels in `csrc/`.

The kernels are compiled with `nvcc` for `sm_90a` (Hopper), one `nvcc`
process per source, all started together, and linked into one shared
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
SOURCES = ("salsa20.cu", "decrypt_tail.cu", "fused_ops.cu", "ntt_stage.cu",
           "behz.cu", "ntt30.cu")
HEADERS = ("modarith.cuh", "ntt_block.cuh", "ntt_cluster.cuh",
           "behz_sums.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
BLOCK_MAX_N = 16384     # one u64 polynomial per block in shared memory:
#                         128 KB
TRANSFORM_MAX_N = 131072  # the cluster kernels (stage and whole-op
#                           transforms): one cluster of 2-8 blocks per
#                           polynomial, 16 for the two-buffer whole-op
#                           launches at 2^17
TRANSFORM30_MAX_N = 65536  # kernel 22 (u32): one cluster of 1-8 blocks
#                            per polynomial, 2-8 at 2^16

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_U32 = ctypes.c_uint32
_U64 = ctypes.c_uint64

# argtypes of every launcher; the last argument is always the stream.
SIGNATURES = {
    # ks (nb * 16 u32 words), nb, key word, nonce, counter0
    "ntt_salsa20": (_P, _L, _U32, _U64, _U64, _P),
    # ks (J * nb * 16 words), nb, key word, nonces (J,) u64, J, counter0
    "ntt_salsa20_batch": (_P, _L, _U32, _P, _I, _U64, _P),
    # x, c0, out, k2_rows, glob, J, r-1, n, pow2, t, neg_t, nu_t, inv_gt
    "ntt_decrypt_tail": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _U64, _U64,
                         _U64, _U64, _P),
    # x, y, out, 4 tables, consts, P, r, log n, cluster size B (0: the
    # launchers' rule)
    "ntt_half_polymul_cluster": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                 _I, _P),
    # s_b, a, e_d, sk, pk0, 4 tables, consts, r, log n, B
    "ntt_keygen_fused_cluster": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                 _I, _I, _P),
    # u_b, pk, e_d, scratch, 4 tables, consts, J, r, log n, B
    "ntt_encrypt_transform_cluster": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                      _I, _I, _I, _P),
    # scratch, m, ct, per_mod, q_last, half, fix_th, J, r, n
    "ntt_encrypt_tail": (_P, _P, _P, _P, _U64, _U64, _U64, _I, _I, _I, _P),
    # u_b, pk, c, 4 tables, consts, r, log n, B
    "ntt_encrypt_front_cluster": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                  _P),
    # c, e, ra, m, ct, per_mod, q_last, fix_th, rl, n
    "ntt_encrypt_tail_padded": (_P, _P, _P, _P, _P, _P, _U64, _U64, _I, _I,
                                _P),
    # c, ra, ct, per_mod, q_last, rl, n
    "ntt_drop_last_padded": (_P, _P, _P, _P, _U64, _I, _I, _P),
    # x, c0, out, per_mod, glob, rl, n, pow2, t, nu_t
    "ntt_decrypt_tail_partial": (_P, _P, _P, _P, _P, _I, _I, _I, _U64, _U64,
                                 _P),
    # scratch c, e, m, ct, per_mod, q_last, half, fix_th, r, n
    "ntt_encrypt_tail_e": (_P, _P, _P, _P, _P, _U64, _U64, _U64, _I, _I, _P),
    # x, d, y, nu, out, 4 tables, consts, prologue, P, r, log n, mod_idx,
    # log2 C, shard
    "ntt_stage_forward": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                          _I, _P, _I, _I, _P),
    # x, y, e, out, 4 tables, consts, prologue, ny, P, r, log n, mod_idx,
    # log2 C, shard
    "ntt_stage_inverse": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                          _I, _P, _I, _I, _P),
    # the same two with the cluster size B last (0: the launchers' rule)
    "ntt_stage_forward_cluster": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                  _I, _I, _I, _P, _I, _I, _I, _P),
    "ntt_stage_inverse_cluster": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                  _I, _I, _I, _P, _I, _I, _I, _P),
    # x, partner, out, 4 tables, consts, inverse, u_side, w, P, r, log n,
    # log2 C
    "ntt_cross_stage": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                        _I, _I, _P),
    # x, sk, c0, scratch, out, 4 tables, consts, per_mod, glob, r-1, log n,
    # pow2, t, neg_t, nu_t, inv_gt, B
    "ntt_decrypt_fused": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                          _I, _I, _U64, _U64, _U64, _U64, _I, _P),
    # which, x, xb, out, 7 banks, C, k, n, row0, rl, group size G (0: the
    # launchers' rule, as the wrappers pass; 1 or 2 forces G, for tests)
    "ntt_behz": (_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                 _I, _I, _P),
    # x, out, 4 tables, consts, inverse, P, r, log n, B
    "ntt30_transform": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
}

# The stage kernels' prologues (ntt_stage.cu PRO_*).
(PRO_COPY, PRO_TERNARY, PRO_ADDNEG_GAUSS, PRO_MONT, PRO_ADDNEG, PRO_DIGIT,
 PRO_KSACC) = range(7)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare argtypes/restype of every launcher of a loaded library."""
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.ntt_error_string.argtypes = [ctypes.c_int]
    lib.ntt_error_string.restype = ctypes.c_char_p
    lib.ntt_stage_cluster_size.argtypes = [ctypes.c_int]
    lib.ntt_stage_cluster_size.restype = ctypes.c_int
    return lib


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels of "
                       "ntt_cuda_tpu_torch are built from csrc/ at first use")


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands together; raise with the output of the first that
    fails, after every one has ended."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}")


def build() -> Path:
    """Compile csrc/*.cu, one nvcc per source in parallel, and link them
    into one shared library (skipped when the hashed build exists); return
    its path."""
    out_dir = CSRC.parents[1] / "build" / f"cuda-{source_hash()}"
    lib = out_dir / "libntt_cuda_tpu_torch.so"
    if lib.is_file():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, tag = find_nvcc(), f".tmp-{os.getpid()}"
    objs = [out_dir / f"{Path(s).stem}{tag}.o" for s in SOURCES]
    tmp = out_dir / f"{tag}.so"
    try:
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(CSRC / s)]
                  for s, o in zip(SOURCES, objs)])
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                   *map(str, objs)]])
        os.replace(tmp, lib)   # atomic: a concurrent build never sees half
    finally:
        for o in objs + [tmp]:
            o.unlink(missing_ok=True)
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The kernels' library, built if needed and loaded once per process."""
    return bind(ctypes.CDLL(str(build())))


def default_device(device, name: str) -> torch.device:
    """`device`, where None is the current CUDA device; raises where there
    is none.  The CPU (the kernels' plain versions) only when asked for."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(f"{name}: no CUDA device (torch.cuda.is_available()"
                           f" is False); pass device='cpu' to run the "
                           f"kernels' plain versions")
    return torch.device("cuda", torch.cuda.current_device())


def kernel_device(name: str, t: torch.Tensor, tables,
                  max_n: int) -> torch.device:
    """The device a transform kernel runs on: the tables' (NTTTables).
    Raises unless `t` is a CUDA tensor and the transform length is in
    [2, max_n]; the caller's `require` checks hold every operand to the
    device returned."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {t.device}")
    if not 2 <= tables.n <= max_n:
        raise ValueError(f"{name}: n={tables.n} outside the kernel's range "
                         f"[2, {max_n}]")
    return tables.device


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
