"""BENCHMARK.json against the benchmark's contract, and every file a cell
names found by name."""
from __future__ import annotations

import json
import re
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
sys.path.insert(0, str(ROOT))
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_and_sizes():
    assert set(MANIFEST) == KEYS["top"]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= MANIFEST["run_seconds"] <= 51 and isinstance(MANIFEST["run_seconds"], int)
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in MANIFEST[kind]:
            extra = set(entry) - KEYS[kind]
            assert extra <= {"workloads"} and (not extra or kind in ("end_to_end", "per_layer"))
            assert KEYS[kind] <= set(entry), (kind, entry["name"])


def test_command_and_paths():
    cmd, paths = MANIFEST["command"], MANIFEST["paths"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir()
    for word in cmd[1:]:
        if "/" in word:
            assert any(word == p or word.startswith(p + "/") for p in paths), word
            assert (ROOT / word).exists()


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_units_unique(kind):
    names = [e["name"] for e in MANIFEST[kind]]
    assert len(names) == len(set(names))
    for e in MANIFEST[kind]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer") + (("source",) if kind == "configs" else ()):
            if key in e:
                assert _line(e[key]), (e["name"], key)


def test_metric_names_unique_across_kinds():
    names = [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    assert len(names) == len(set(names))


def test_end_to_end_bounds_and_sources():
    names = {m["name"] for m in MANIFEST["end_to_end"]}
    assert "setup_s" in names and 1 <= len(names) <= 16
    for m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_configs_files_and_reduced():
    used = {w["config"] for w in MANIFEST["workloads"]}
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(files) == len(set(files))
    for c in MANIFEST["configs"]:
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in MANIFEST["paths"])
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["source"] == c["source"]
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and key in body and key in body["source_values"]
            assert body[key] != body["source_values"][key]
            assert not key.endswith(("_dim", "_rank"))


def test_cells_find_their_files():
    from portbench.harness import load_cell, load_module

    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(1 for w in MANIFEST["workloads"] if w["chips"] == 4)
    assert four <= max(1, len(MANIFEST["workloads"]) // 4)
    for w in MANIFEST["workloads"]:
        assert w["chips"] in (1, 4) and NAME.match(w["traffic"]) and NAME.match(w["config"])
        cell = load_cell(w["name"], MANIFEST)
        load_module("cases", cell.config["case"])
        load_module("routes", cell.traffic["route"])
        for kind in cell.traffic["frame_work"]:
            load_module("frames", kind)
        assert cell.limits, w["name"]
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert len(cell.end_to_end) >= 2 and cell.per_layer


def test_per_layer_readers_and_moves():
    from portbench.harness import load_module

    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    cells = {w["name"] for w in MANIFEST["workloads"]}
    layers: dict[str, str] = {}
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert set(m.get("workloads", cells)) <= cells
        assert callable(load_module("metrics", m["name"]).read)
        layers.setdefault(m["layer"].split(" ")[0], m["layer"])
        assert layers[m["layer"].split(" ")[0]] == m["layer"]
