"""Finding a cell's data and code by name: BENCHMARK.json at the root of the
checkout, configurations under portbench/configs, traffic mixes under
portbench/traffic, per-layer metric readers under portbench/metrics and
kernel counts under portbench/kernels."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
ROOT = PKG.parent


def load_module(path):
    """A Python file as a fresh module (names may hold dots)."""
    path = Path(path)
    name = "portbench_file_" + "".join(c if c.isalnum() else "_" for c in str(path.relative_to(ROOT)))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def manifest(root=ROOT):
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def cell(name, bench):
    """(workload entry, configuration entry, configuration file's dict,
    traffic file's dict) of the cell `name`."""
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(work)})")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(ROOT / conf["file"]) as f:
        config = json.load(f)
    with open(PKG / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    return w, conf, config, traffic


def reference(name):
    """A plain reference module of portbench/reference by name."""
    return importlib.import_module(f"portbench.reference.{name}")


def kernels():
    """{kernel name: its count module} of every file under kernels/."""
    return {p.stem: load_module(p) for p in sorted((PKG / "kernels").glob("*.py"))}


def metric_reader(name):
    return load_module(PKG / "metrics" / f"{name}.py")


def cell_metrics(bench, cell_name, which):
    """The `end_to_end` or `per_layer` entries that cell `cell_name` reports."""
    return [m for m in bench[which] if cell_name in m.get("workloads", [cell_name])]
