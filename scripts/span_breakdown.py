#!/usr/bin/env python3
"""One traced run of a benchmark cell, broken down by the program's own
spans and counters (one CUDA GPU; four for the four-card cell).

    python3 scripts/span_breakdown.py --workload <cell> --seed <n>
        [--seconds 5] [--out build/spans_<cell>_<seed>.json]

Runs the cell as `portbench/run.py --trace 1` does (set-up, the traced
calls, the window, the check) and then reads its traced window against
the program's registry (utils/log.py, read through portbench/harness/
spans.py):

- every replay of a kept graph found in the trace (runs whose kernel
  names equal a graph's table one for one), against the traced calls,
  with the launches each lost in the trace and the other work's kernels
  skipped inside it;
- the replays' device ms a call by leaf span, by bounce stage and by step
  phase, the kernels outside the replays, the sum of the stages against
  the replays' kernel ms and of the phases and eager_ms against the
  window's kernel ms (the profiler's annotations on the device's
  timeline left out of both, and reported apart);
- the stage (and phase) each hand-written kernel of portbench/kernels
  landed in, and the device events outside the replays by name (a call's
  count and ms);
- the window's ten longest idle gaps on the card, each put down to the
  harness's range and to the innermost program span whose host record
  holds the gap's middle (the shared clock);
- the worst device start before its replay's frame.replay span began
  (device and host stamps on the card, worst case);
- Statistics: the host seconds of every span path a call, the cache's
  counters.

Prints the result line as run.py would, then one JSON summary line; the
summary goes to --out as well.
"""

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parent.parent


def innermost(records, t):
    """The deepest program span record holding host time t (ns)."""
    best = None
    for path, _, start, end in records:
        if start <= t <= end and (best is None or path.count("/") > best.count("/")):
            best = path
    return best


def breakdown(win, log, spans):
    """The summary of a traced window (see the module's docstring)."""
    found = spans.matches(win)
    runs = [m[:2] for m in found]
    counts = {}
    for table, _ in runs:
        counts.setdefault(id(table), [table, 0])[1] += 1
    kernel_ns = sum(d for _, _, d in spans.real_kernels(win))
    annotation_ns = sum(d for n, _, d in win.kernel_events() if spans.is_annotation(n))
    replay_ns = sum(e[2] for _, credited in runs for e, _ in credited)
    out = {
        "reps": win.reps,
        "tables": [{"kind": t.kind, "nodes": t.nodes,
                    "kernels": None if t.kernels is None else len(t.kernels),
                    "copies": len(t.copies), "marks": t.marks,
                    "replays_matched": counts.get(id(t), [t, 0])[1],
                    "replays_with_lost_launches": sum(1 for m in found if m[0] is t and m[2]),
                    "lost_launches": sum(m[2] for m in found if m[0] is t),
                    "foreign_kernels_skipped": sum(m[3] for m in found if m[0] is t),
                    "kernels_credited_a_replay": [len(c) for tt, c in runs if tt is t][:3]}
                   for t in log.GRAPHS],
        "kernel_ms_a_call": kernel_ns / 1e6 / win.reps,
        "annotation_ms_a_call": annotation_ns / 1e6 / win.reps,
        "replay_ms_a_call": replay_ns / 1e6 / max(len(runs), 1),
        "by_leaf": spans.device_ms(win, lambda p: p),
        "by_stage": spans.device_ms(win, spans.stage),
        "by_phase": spans.device_ms(win, spans.phase),
        "eager_ms": spans.eager_ms(win),
        "host_ms": spans.host_ms(win),
        "live_share": spans.live_share(win),
    }
    if out["by_stage"]:
        six = ("intersect", "emitter", "shadow", "bsdf", "compact", "film")
        out["six_stages_ms"] = sum(out["by_stage"].get(k, 0.0) for k in six)
    if out["by_phase"] and out["eager_ms"] is not None:
        out["phases_and_eager_ms"] = out["eager_ms"] + sum(
            out["by_phase"].get(k, 0.0) for k in ("update", "forward", "backward"))
    landed = {}
    for name, k in win.kernels.items():
        where = {}
        for _, credited in runs:
            for (n, _, d), p in credited:
                if k.TRACE_NAME in n:
                    key = f"{spans.phase(p)}/{spans.stage(p)}"
                    where[key] = where.get(key, 0) + d / 1e6 / len(runs)
        if where:
            landed[name] = where
    out["hand_written"] = landed
    # the device events outside every replay, by name (copies and the
    # profiler's own annotations on the device timeline among them)
    credited = {id(e) for _, c in runs for e, _ in c}
    eager = {}
    for e in win.events:
        if id(e) not in credited:
            n, ms = eager.setdefault(e[0][:100], [0, 0.0]), e[2] / 1e6
            n[0] += 1 / win.reps
            n[1] += ms / win.reps
    out["outside_replays"] = dict(sorted(eager.items(), key=lambda kv: -kv[1][1])[:12])
    # the idle gaps, by the harness's range and the innermost program span
    records = [r for r in log.RECORDS
               if any(s <= r[2] and r[3] <= s + d for _, s, d in win.host)]
    ivals = sorted((s, s + d) for _, s, d in win.events)
    gaps, end = [], None
    for s, e in ivals:
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    gaps.sort(key=lambda g: g[0] - g[1])
    out["idle_gaps"] = []
    for a, b in gaps[:10]:
        mid = (a + b) / 2
        harness = [n for n, s, d in win.host if s <= mid <= s + d]
        out["idle_gaps"].append({"ms": (b - a) / 1e6,
                                 "harness": harness[-1] if harness else None,
                                 "program": innermost(records, mid)})
    # device starts before their replay's host span (clock offsets)
    replay_recs = sorted(r for r in ((r[2], r[0]) for r in records)
                         if r[1].rsplit("/", 1)[-1] == "frame.replay")
    firsts = sorted(credited[0][0][1] for _, credited in runs)
    if replay_recs and len(replay_recs) == len(firsts):
        out["worst_device_before_host_us"] = max(
            (h - d) / 1e3 for (h, _), d in zip(replay_recs, firsts))
        out["least_launch_lag_us"] = min((d - h) / 1e3 for (h, _), d in zip(replay_recs, firsts))
    st = log.Statistics.get()
    out["statistics"] = {k: {"count": st.counters.get(k, 0), "s": st.timers.get(k)}
                         for k in sorted(set(st.counters) | set(st.timers))
                         if k.startswith("frame.") or k in ("optimizer", "allreduce")}
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--out")
    a = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import run as prun
    from portbench.harness import files, spans

    prun._caches()
    import torch

    torch.set_num_threads(1)
    bench = files.manifest(ROOT)
    work, _, config, traffic = files.cell(a.workload, bench)
    traffic = dict(traffic, name=work["traffic"])
    entry = importlib.import_module(f"portbench.harness.{traffic['entry']}")
    res, checks = entry.run(config, traffic, a.seed, a.seconds, True, T_START, "cuda", prun.log)
    result = prun._result(bench, work, res, checks, True, "cuda")
    print(json.dumps(result), flush=True)
    summary = {"workload": a.workload, "seed": a.seed, "card": torch.cuda.get_device_name(0),
               "setup_s": res["setup_s"], "window_s": res["window"].window_s,
               **breakdown(res["window"], spans.registry(), spans)}
    out = Path(a.out or ROOT / "build" / f"spans_{a.workload}_{a.seed}.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
