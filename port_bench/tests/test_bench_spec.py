"""``BENCHMARK.json`` keeps the benchmark's contract: the keys, names,
units and lengths it allows, every cell's configuration and traffic file,
every metric's reader, and a limit for every number a cell compares."""

import json
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size < 64 * 1024
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["paths"]) <= 16 and len(BENCH["command"]) <= 32
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert (ROOT / p).is_dir()
    for word in BENCH["command"]:
        assert LINE.match(word) and not word.startswith("/")
        assert ".." not in word


def test_configs():
    assert 1 <= len(BENCH["configs"]) <= 24
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert c["file"].startswith("port_bench/") and c["file"] not in files
        files.add(c["file"])
        conf = json.loads((ROOT / c["file"]).read_text())
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and key in conf["reduced"]


def test_workloads():
    assert 1 <= len(BENCH["workloads"]) <= 24
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and LINE.match(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (ROOT / "port_bench" / "traffic" / f"{w['traffic']}.json"
                ).is_file()
    fours = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert fours <= max(1, len(BENCH["workloads"]) // 4)


def _metrics():
    return [(k, m) for k in ("end_to_end", "per_layer") for m in BENCH[k]]


@pytest.mark.parametrize("kind,m", _metrics(), ids=lambda x: getattr(
    x, "get", lambda _: x)("name") if isinstance(x, dict) else x)
def test_metric(kind, m):
    allowed = {"name", "unit", "better", "source", "workloads"}
    allowed |= {"bound"} if kind == "end_to_end" else {"layer", "moves"}
    assert set(m) <= allowed and NAME.match(m["name"])
    assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert (ROOT / "port_bench" / "metrics" / f"{m['name']}.py").is_file()
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(m.get("workloads", cells)) <= cells
    if kind == "end_to_end":
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert LINE.match(m["layer"])
        moved = {e["name"]: e for e in BENCH["end_to_end"]}[m["moves"]]
        reporting = set(moved.get("workloads", cells))
        assert set(m.get("workloads", reporting)) <= reporting


def test_every_cell_reports_setup_and_another_metric_and_a_layer():
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in names
    for w in BENCH["workloads"]:
        e2e = [m for m in BENCH["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])]
        assert len(e2e) >= 2
        assert any(w["name"] in m.get("workloads", [w["name"]])
                   for m in BENCH["per_layer"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_limits(cell):
    lim = json.loads((ROOT / "port_bench" / "limits" / f"{cell}.json")
                     .read_text())["limits"]
    assert {"loss", "grad", "change"} <= set(lim)
    assert all(0 < v < 1 for v in lim.values())
