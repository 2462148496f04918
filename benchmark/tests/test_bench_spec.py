"""BENCHMARK.json keeps to the benchmark's contract, and every file it
names is there."""

import json
import re

from benchmark.harness import spec
from benchmark.harness.spec import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
E2E_KEYS = {"name", "unit", "better", "bound", "source", "workloads"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves", "workloads"}


def load():
    return spec.load_spec()


def test_top_level_keys_and_command():
    s = load()
    assert set(s) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert s["command"] == ["python3", "benchmark/run.py"]
    assert s["paths"] == ["benchmark"]
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p for p in s["paths"])
    assert isinstance(s["run_seconds"], int) and 1 <= s["run_seconds"] <= 51
    assert len(json.dumps(s)) <= 64 * 1024


def test_names_units_and_one_line_texts():
    s = load()
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in s[k]]
    assert all(NAME.match(n) for n in names), names
    assert len(set(x["name"] for x in s["end_to_end"] + s["per_layer"])) == \
        len(s["end_to_end"]) + len(s["per_layer"])
    assert len({x["name"] for x in s["workloads"]}) == len(s["workloads"])
    for m in s["end_to_end"] + s["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for x in s["configs"] + s["workloads"]:
        assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"] and "\t" not in x["why"]
    for w in s["workloads"]:
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])


def test_configs_workloads_and_files():
    s = load()
    cfg_names = {c["name"] for c in s["configs"]}
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        assert c["source"].startswith("https://")
        assert len(c["reduced"]) <= 16
        assert any(w["config"] == c["name"] for w in s["workloads"])
    assert len({c["file"] for c in s["configs"]}) == len(s["configs"])
    pairs = [(w["config"], w["traffic"]) for w in s["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in cfg_names and w["chips"] in (1, 4)
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()
        assert (BENCH / "drivers" / f"{spec.traffic(w['traffic'])['driver']}.py").is_file()
    four = [w for w in s["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(s["workloads"]) // 4)


def test_metrics_are_reported_where_they_move():
    s = load()
    cells = {w["name"] for w in s["workloads"]}
    e2e = {m["name"]: m for m in s["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in s["end_to_end"]:
        assert set(m) <= E2E_KEYS and m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
    for m in s["per_layer"]:
        assert set(m) == LAYER_KEYS, m
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
        assert m["moves"] in e2e
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in cells
            assert cell in moved.get("workloads", cells), (m["name"], cell)
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline") or "mfu" in m["name"] or "roofline" in m["name"]:
            assert m["unit"] == "%"
    for cell in cells:
        assert any(cell in m.get("workloads", cells) for m in s["end_to_end"]
                   if m["name"] != "setup_s")
        assert any(cell in m["workloads"] for m in s["per_layer"])


def test_every_metric_file_has_a_reader():
    s = load()
    for m in s["end_to_end"] + s["per_layer"]:
        assert callable(spec.reader(m["name"]).read)
