"""Run one cell of the port's benchmark once and print its result.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration and its traffic mix are found by name from
BENCHMARK.json (portbench/README.md). The last line of standard output is
one JSON object: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics with --trace 0, its per-layer metrics with --trace 1),
`device`, with --trace 1 `breakdown`, and last `checks`, the numbers
compared against the plain reference with their limits, which also end
standard error. Exits non-zero, printing no result, without CUDA or the
cards the cell asks for, when the run is not whole, or when JAX or the JAX
package was imported.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "mitsuba_customization_tpu")


def _caches():
    """Every build and kernel cache inside the checkout, at fixed paths."""
    cache = ROOT / "build" / "portbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    # one process, few threads: the host's share of a call stays steady
    os.environ["OMP_NUM_THREADS"] = "1"


def log(msg):
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run_cell(name, seed, seconds, trace, device="cuda", bench=None, overrides=None):
    """One run of cell `name`: (result dict as printed, checks). overrides:
    {"config": {...}, "traffic": {...}} merged over the files' dicts (the
    CPU tests' small sizes)."""
    import importlib

    from portbench.harness import files

    bench = bench or files.manifest(ROOT)
    work, _, config, traffic = files.cell(name, bench)
    overrides = overrides or {}
    config = dict(config, **overrides.get("config", {}))
    traffic = dict(traffic, name=work["traffic"], **overrides.get("traffic", {}))
    # the traffic's entry is the harness module of that name
    entry = importlib.import_module(f"portbench.harness.{traffic['entry']}")
    res, checks = entry.run(config, traffic, seed, seconds, trace, T_START, device, log)
    return _result(bench, work, res, checks, trace, device), checks


def _result(bench, work, res, checks, trace, device):
    import torch

    from portbench.harness import files

    out = {"correct": bool(res["correct"]), "attempted": res["attempted"],
           "failed": res["failed"]}
    metrics = {}
    if not trace:
        for m in files.cell_metrics(bench, work["name"], "end_to_end"):
            value = res["setup_s"] if m["name"] == "setup_s" else res["e2e"][m["name"]]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        win = res["window"]
        for m in files.cell_metrics(bench, work["name"], "per_layer"):
            value = files.metric_reader(m["name"]).read(win)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out["metrics"] = metrics
    on_card = device == "cuda"
    out["device"] = {"platform": "gpu" if on_card else "cpu",
                     "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                     "count": work["chips"], "memory_peak_bytes": res["memory_peak_bytes"]}
    if trace:
        win = res["window"]
        out["device"]["busy_s"] = win.busy_s()
        out["device"]["window_s"] = win.window_s
        out["breakdown"] = {"device_ops": win.top_ops(), "idle_gaps": win.idle_gaps()}
    out["checks"] = checks
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    _caches()
    sys.path.insert(0, str(ROOT))
    from portbench.harness import files

    bench = files.manifest(ROOT)
    work = files.cell(a.workload, bench)[0]
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < work["chips"]:
        log(f"{a.workload} needs {work['chips']} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    out, checks = run_cell(a.workload, a.seed, a.seconds, bool(a.trace), "cuda", bench)
    found = forbidden_modules()
    if found:
        log(f"modules loaded that the benchmark must not load: {found}")
        return 3
    for k, c in checks.items():
        log(f"check {k}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
