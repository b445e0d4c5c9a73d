"""BENCHMARK.json against the contract's characters and keys, and every
cell's files found by name."""
import json
import re

import pytest

from benchmark import harness

MAN = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
CELLS = [w["name"] for w in MAN["workloads"]]


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert 1 <= len(MAN["paths"]) <= 16 and all(PATH.match(p) for p in MAN["paths"])
    assert len(MAN["command"]) <= 32 and not any(w.startswith("/") for w in MAN["command"])
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_keys():
    names = set()
    for kind, keys in (("configs", {"name", "source", "file", "reduced", "why"}),
                       ("workloads", {"name", "config", "traffic", "chips", "why"}),
                       ("end_to_end", {"name", "unit", "better", "bound", "source"}),
                       ("per_layer", {"name", "unit", "better", "source", "layer", "moves"})):
        seen = set()
        for entry in MAN[kind]:
            assert set(entry) - {"workloads"} == keys, entry
            assert NAME.match(entry["name"]), entry["name"]
            assert entry["name"] not in seen
            seen.add(entry["name"])
            for text in ("why", "layer", "source"):
                if text in entry:
                    assert 1 <= len(entry[text]) <= 200 and "\n" not in entry[text]
                    assert "\t" not in entry[text]
            if "unit" in entry:
                assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
        if kind in ("end_to_end", "per_layer"):
            assert not names & seen
            names |= seen


def test_bounds_and_metric_sources():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        for cell in m.get("workloads", CELLS):   # the cell reports what the metric moves
            assert cell in e2e[m["moves"]].get("workloads", CELLS)
        if m["name"].endswith("_roofline") or "mfu" in m["name"] or m["unit"] == "%":
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    workload, config = harness.load_cell(cell)
    assert (harness.BENCH_DIR / "drivers" / f"{workload['driver']}.py").is_file()
    entry = next(w for w in MAN["workloads"] if w["name"] == cell)
    cfg_entry = next(c for c in MAN["configs"] if c["name"] == entry["config"])
    assert workload["config"] == entry["config"] == config["name"]
    assert cfg_entry["file"] == f"benchmark/configs/{config['name']}.json"
    assert cfg_entry["reduced"] == config["reduced"] and cfg_entry["source"] == config["source"]
    assert entry["chips"] in (1, 4) and len(entry["why"]) <= 200
    assert set(workload["limits"]), "a cell compares at least one number"
    for m in harness.metrics_of(MAN, cell, "per_layer"):
        assert harness.metric_file(m["name"]).is_file()
    kinds = [m["name"] for m in harness.metrics_of(MAN, cell, "end_to_end")]
    assert "setup_s" in kinds and len(kinds) >= 2
    assert harness.metrics_of(MAN, cell, "per_layer")


def test_every_config_used_and_pairs_unique():
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in MAN["workloads"]) <= max(1, len(CELLS) // 4)


def test_gitignore_keeps_caches_out():
    ignored = (harness.ROOT / ".gitignore").read_text().split()
    assert "benchmark/.cache/" in ignored
    assert json.loads((harness.ROOT / "BENCHMARK.json").read_text()) == MAN
