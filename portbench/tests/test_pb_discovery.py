"""A cell, a configuration, a traffic mix and a metric added as new files
(and manifest entries) are found by name, with no existing file edited."""

import hashlib
import json
import shutil

import pytest

from portbench.harness import manifest
from portbench.harness.manifest import BENCH, ROOT


def digest(root) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).digest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_files_are_found_without_editing(tmp_path):
    root = tmp_path / "checkout"
    bench = root / "portbench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = digest(bench)

    cfg = json.load(open(bench / "configs" / "32k_9q.json"))
    (bench / "configs" / "32k_9q_copy.json").write_text(
        json.dumps(dict(cfg, name="32k_9q_copy")))
    (bench / "traffic" / "mulrelin_j4.json").write_text(json.dumps(
        {"op": "mulrelin", "J": 4, "ct_pool": 64, "check_requests": 1}))
    (bench / "metrics" / "requests_per_s.py").write_text(
        "def read(rec):\n    return rec.requests / rec.elapsed\n")
    (bench / "metrics" / "busy_share.new.py").write_text(
        "def read(rec):\n    return None\n")
    m = json.load(open(root / "BENCHMARK.json"))
    m["configs"].append({"name": "32k_9q_copy", "source": "x",
                         "file": "portbench/configs/32k_9q_copy.json",
                         "reduced": [], "why": "a copy"})
    m["workloads"].append({"name": "32k_9q_copy.mulrelin4",
                           "config": "32k_9q_copy",
                           "traffic": "mulrelin_j4", "chips": 1,
                           "why": "added by files alone"})
    m["end_to_end"].append({"name": "requests_per_s", "unit": "req/s",
                            "better": "higher", "bound": 0.05,
                            "source": "host_clock",
                            "workloads": ["32k_9q_copy.mulrelin4"]})
    m["per_layer"].append({"name": "busy_share.new", "unit": "%",
                           "better": "higher", "source": "device_trace",
                           "layer": "device", "moves": "requests_per_s",
                           "workloads": ["32k_9q_copy.mulrelin4"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))

    spec = manifest.cell(manifest.load_manifest(root),
                         "32k_9q_copy.mulrelin4", root=root, bench=bench)
    assert spec["config"]["name"] == "32k_9q_copy"
    assert spec["traffic"]["J"] == 4
    assert {x["name"] for x in spec["end_to_end"]} >= {"requests_per_s",
                                                       "setup_s"}
    assert [x["name"] for x in spec["per_layer"]] == ["busy_share.new"]
    assert spec["traffic"]["op"] == "mulrelin" and hasattr(spec["op"],
                                                           "Cell")
    after = digest(bench)
    assert all(after[k] == v for k, v in before.items())


def test_per_layer_metric_without_workloads_is_refused():
    m = manifest.load_manifest()
    m["per_layer"][0] = {k: v for k, v in m["per_layer"][0].items()
                         if k != "workloads"}
    with pytest.raises(KeyError, match="workloads"):
        manifest.cell(m, m["workloads"][0]["name"])
