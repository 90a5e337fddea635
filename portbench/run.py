"""Run one benchmark cell once and print its result as the last line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds BENCHMARK.json, portbench/ and the
ntt_cuda_tpu_torch package.  Needs a CUDA card (exits 2 without one: no
CPU fallback).  With --trace 0 the metrics are the cell's end-to-end ones,
with --trace 1 its per-layer ones.  Standard error ends with each number
the check compared beside its limit; the JSON line's last key, `checks`,
repeats them.
"""

import time

T0 = time.perf_counter()   # the process's start, for setup_s

import argparse   # noqa: E402
import json       # noqa: E402
import os         # noqa: E402
import sys        # noqa: E402
from pathlib import Path   # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    # every build and kernel cache inside the checkout, at fixed paths (the
    # library's own nvcc build goes to <checkout>/build/cuda-<hash>/)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / sub)
    sys.path.insert(0, str(ROOT))
    from portbench.harness import manifest, runner

    spec = manifest.cell(manifest.load_manifest(ROOT), args.workload)
    import torch
    chips = int(spec["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: the cell needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    try:
        import ntt_cuda_tpu_torch
    except ImportError as e:
        print(f"no result: the library is not in this checkout ({e})",
              file=sys.stderr)
        return 2
    lib = Path(ntt_cuda_tpu_torch.__file__).resolve()
    if ROOT not in lib.parents:
        print(f"no result: ntt_cuda_tpu_torch loaded from {lib}, outside "
              f"the checkout {ROOT}", file=sys.stderr)
        return 2
    result, lines = runner.run_cell(spec, args.seed, args.seconds,
                                    bool(args.trace), T0,
                                    torch.device("cuda", 0))
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
