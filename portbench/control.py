"""The control: the plain reference put in the program's place with every
modular product taken through float64, run as a cell is run (set-up, a
short window at the cell's load, the same check).  It has to come out not
correct; its compared numbers are the upper readings the limits are set
below.  Not part of a benchmark run.

    python3 portbench/control.py --workload <name> --seeds 1,2,3 --seconds 3
"""

import time

T0 = time.perf_counter()

import argparse   # noqa: E402
import json       # noqa: E402
import sys        # noqa: E402
from pathlib import Path   # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch
    from portbench.harness import manifest, runner
    from portbench.harness.systems import Reference

    spec = manifest.cell(manifest.load_manifest(ROOT), args.workload)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    control = lambda cfg, dev: Reference(cfg, dev, fp64=True)
    for seed in (int(s) for s in args.seeds.split(",")):
        result, lines = runner.run_cell(spec, seed, args.seconds, False,
                                        time.perf_counter(), device,
                                        make_system=control)
        print("\n".join(lines), file=sys.stderr)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": result["correct"],
                          "attempted": result["attempted"],
                          "checks": result["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
