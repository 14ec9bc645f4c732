"""BENCHMARK.json and the files it names hold to the benchmark's contract."""

import json
import math
import re

import pytest

from portbench.harness import files

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module")
def bench():
    return files.manifest()


def _line(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_and_sizes(bench):
    assert set(bench) == KEYS["top"]
    assert len(json.dumps(bench)) <= 64 * 1024
    assert 1 <= bench["run_seconds"] <= 51 and bench["run_seconds"] == int(bench["run_seconds"])
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    assert len(bench["command"]) <= 32 and all(_line(w) for w in bench["command"])
    for word in bench["command"][1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in bench["paths"])


def test_names_units_and_entries(bench):
    for kind, key in (("configs", "config"), ("workloads", "workload"),
                      ("end_to_end", "end_to_end"), ("per_layer", "per_layer")):
        entries = bench[kind]
        names = [e["name"] for e in entries]
        assert len(names) == len(set(names)), kind
        for e in entries:
            extra = {"workloads"} if kind in ("end_to_end", "per_layer") else set()
            assert KEYS[key] <= set(e) <= KEYS[key] | extra, e
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    metric_names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(metric_names) == len(set(metric_names))


def test_configs(bench):
    assert 1 <= len(bench["configs"]) <= 24
    used = {w["config"] for w in bench["workloads"]}
    file_names = [c["file"] for c in bench["configs"]]
    assert len(file_names) == len(set(file_names))
    for c in bench["configs"]:
        assert c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in bench["paths"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        with open(files.ROOT / c["file"]) as f:
            body = json.load(f)
        assert body["reduced"] == c["reduced"]
        assert (files.PKG / "configs" / body["scene"]).exists()


def test_workloads(bench):
    ws = bench["workloads"]
    assert 1 <= len(ws) <= 24
    pairs = [(w["config"], w["traffic"]) for w in ws]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in ws)
    assert four <= max(1, len(ws) // 4)
    for w in ws:
        assert w["chips"] in (1, 4) and _line(w["why"]) and NAME.match(w["traffic"])
        assert (files.PKG / "traffic" / f"{w['traffic']}.json").exists()
        _, _, config, traffic = files.cell(w["name"], bench)
        assert w["traffic"] in config["limits"]
        assert (files.PKG / "harness" / f"{traffic['entry']}.py").exists()
        assert (files.PKG / "reference" / f"{config['reference']}.py").exists()


def test_metrics(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert 1 <= len(e2e) <= 16 and "setup_s" in e2e
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells
    layers = {}
    assert 1 <= len(bench["per_layer"]) <= 128
    for m in bench["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
        for c in m.get("workloads", cells):
            assert c in e2e[m["moves"]].get("workloads", cells)
        assert (files.PKG / "metrics" / f"{m['name']}.py").exists()
        if "_roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for c in cells:
        reported = files.cell_metrics(bench, c, "end_to_end")
        assert "setup_s" in [m["name"] for m in reported] and len(reported) >= 2
        assert files.cell_metrics(bench, c, "per_layer")


def test_run_seconds_fit_the_check(bench):
    # 24 cells, 2 + 14 x cells runs of run_seconds + 60 s, 2 x 90 s a cell to
    # compile, 1200 s spare: within 43,200 s
    cells = 24
    total = (2 + 14 * cells) * (bench["run_seconds"] + 60) + cells * 180 + 1200
    assert total <= 43200 and not math.isnan(total)
