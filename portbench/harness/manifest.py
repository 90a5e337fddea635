"""The benchmark's manifest (BENCHMARK.json at the checkout's root) and the
files each name in it stands for.

Everything that belongs to one configuration, traffic mix, op or metric
sits in a file of its own, found by its name:

* configuration `<c>`: `configs/<c>.json` (its `file` in the manifest);
* traffic `<t>`: `traffic/<t>.json`, whose `op` names the op module;
* op `<o>`: `ops/<o>.py`, which sets up a cell and issues its requests;
* metric `<m>` (end to end or per layer): `metrics/<m>.py`, a reader.

A later change adds a cell by adding these files and manifest entries,
never by editing a file that is there.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]      # portbench/
ROOT = BENCH.parent                              # the checkout


def load_manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A Python file as a module (names may hold dots: metric names)."""
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(
        "portbench_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(manifest: dict, workload: str, root: Path = ROOT,
         bench: Path = BENCH) -> dict:
    """Everything one cell names, resolved to loaded data and modules:
    the workload entry, the configuration, the traffic, the op module and
    the metrics it reports (end to end; per layer) with their readers."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[workload]
    cfgs = {c["name"]: c for c in manifest["configs"]}
    cfg_entry = cfgs[w["config"]]
    with open(root / cfg_entry["file"]) as f:
        config = json.load(f)
    with open(bench / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    op = load_module(bench / "ops" / f"{traffic['op']}.py", traffic["op"])

    def reported(metrics: list, every_cell: bool) -> list:
        """The metrics this cell reports: those whose `workloads` name it,
        and end-to-end ones without the key (reported by every cell).  A
        per-layer metric has to carry the key."""
        out = []
        for m in metrics:
            if "workloads" not in m and not every_cell:
                raise KeyError(f"per-layer metric {m['name']!r} has no "
                               f"`workloads` list")
            if workload in m.get("workloads", (workload,)):
                out.append(dict(m, reader=load_module(
                    bench / "metrics" / f"{m['name']}.py", m["name"])))
        return out

    e2e = reported(manifest["end_to_end"], True)
    per_layer = reported(manifest["per_layer"], False)
    return dict(workload=w, config=config, traffic=traffic, op=op,
                end_to_end=e2e, per_layer=per_layer)
