"""BENCHMARK.json against the benchmark's contract: names, units, limits,
the files each name stands for, and which cells report which metric."""

import json
import re

from portbench.harness import manifest
from portbench.harness.manifest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "e2e": {"name", "unit", "better", "bound", "source"},
    "layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def text_ok(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_manifest_keys_names_and_units():
    m = manifest.load_manifest()
    assert set(m) == KEYS["top"]
    assert m["paths"] == ["portbench"] and len(m["command"]) <= 32
    assert all(text_ok(w) for w in m["command"])
    assert 1 <= m["run_seconds"] <= 51
    for c in m["configs"]:
        assert set(c) == KEYS["config"]
        assert NAME.match(c["name"]) and text_ok(c["source"])
        assert text_ok(c["why"]) and c["file"].startswith("portbench/")
        assert all(NAME.match(k) for k in c["reduced"])
    for w in m["workloads"]:
        assert set(w) == KEYS["workload"]
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and text_ok(w["why"])
    for key, kind in (("end_to_end", "e2e"), ("per_layer", "layer")):
        for x in m[key]:
            assert set(x) - {"workloads"} == KEYS[kind], x["name"]
            assert NAME.match(x["name"]) and UNIT.match(x["unit"])
            assert x["better"] in ("lower", "higher")
    for x in m["end_to_end"]:
        assert x["source"] in ("host_clock", "device_trace")
        assert 0.01 <= x["bound"] <= 0.25
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in m[k]]
    assert len(names) == len(set(names))
    assert len(json.dumps(m)) <= 64 * 1024


def test_every_cell_resolves_and_reports_what_its_metrics_move():
    m = manifest.load_manifest()
    e2e_names = {x["name"] for x in m["end_to_end"]}
    for w in m["workloads"]:
        spec = manifest.cell(m, w["name"])
        reported = {x["name"] for x in spec["end_to_end"]}
        assert "setup_s" in reported and len(reported) >= 2
        assert spec["per_layer"], w["name"]
        for x in spec["per_layer"]:
            assert x["moves"] in e2e_names and x["moves"] in reported
        for x in spec["end_to_end"] + spec["per_layer"]:
            assert callable(x["reader"].read)
        assert hasattr(spec["op"], "Cell")


def test_per_layer_workloads_match_the_cells_of_their_moved_metric():
    m = manifest.load_manifest()
    cells = {w["name"] for w in m["workloads"]}
    e2e = {x["name"]: set(x.get("workloads", cells)) for x in m["end_to_end"]}
    layers = {}
    for x in m["per_layer"]:
        assert set(x["workloads"]) == e2e[x["moves"]], x["name"]
        layers.setdefault(x["name"].split(".")[0], set()).add(x["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_configs_state_the_published_sets_unreduced():
    m = manifest.load_manifest()
    for c in m["configs"]:
        cfg = json.load(open(ROOT / c["file"]))
        assert cfg["name"] == c["name"] and c["reduced"] == []
        assert len(cfg["q"]) == len(cfg["psi"]) and cfg["t"] == 1024
        for q, psi in zip(cfg["q"], cfg["psi"]):
            assert pow(psi, cfg["n"], q) == q - 1        # a 2n-th root
        for traffic, sizes in cfg["assumed"]["cells"].items():
            t = json.load(open(BENCH / "traffic" / f"{traffic}.json"))
            assert all(t[k] == v for k, v in sizes.items()), traffic


def test_full_check_fits_its_time():
    m = manifest.load_manifest()
    runs = 2 + 14 * 24
    total = runs * (m["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200
    four = sum(w["chips"] == 4 for w in m["workloads"])
    assert four <= max(1, len(m["workloads"]) // 4)
