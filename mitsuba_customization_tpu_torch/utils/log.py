"""Logging and render statistics.

PyTorch port of mitsuba_customization_tpu/utils/log.py (mitsuba3's
logger and the 0.6 Statistics singleton): a std-logging logger named
`mitsuba_customization_tpu_torch`, a process-wide registry of counters and
timers printed after renders, and a JSONL metrics writer for optimisation
loops.

`timed` measures host wall time. Around CUDA work it measures the time to
launch that work, not to run it, unless the caller synchronises
(`torch.cuda.synchronize()`) before the block ends.
"""

from __future__ import annotations

import json
import logging
import time
from collections import defaultdict

logger = logging.getLogger("mitsuba_customization_tpu_torch")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(
        logging.Formatter("%(asctime)s %(name)s [%(levelname)s] %(message)s")
    )
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)


def set_log_level(level):
    """Trace/Debug/Info/Warn/Error: Logger::set_log_level."""
    logger.setLevel(level)


class Statistics:
    """Process-wide counters and timers: Statistics::getInstance."""

    _instance = None

    def __init__(self):
        self.counters = defaultdict(int)
        self.timers = defaultdict(float)

    @classmethod
    def get(cls):
        if cls._instance is None:
            cls._instance = Statistics()
        return cls._instance

    def add(self, name, value=1):
        self.counters[name] += int(value)

    def add_time(self, name, seconds):
        self.timers[name] += float(seconds)

    def reset(self):
        self.counters.clear()
        self.timers.clear()

    def print_stats(self):
        """Statistics::printStats: every counter and timer to the log."""
        for name, v in sorted(self.counters.items()):
            logger.info("stat %-40s %d", name, v)
        for name, v in sorted(self.timers.items()):
            logger.info("stat %-40s %.3fs", name, v)


class timed:
    """Context manager: add the block's host wall time to a Statistics
    timer (launch time only around unsynchronised CUDA work)."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        Statistics.get().add_time(self.name, time.perf_counter() - self.t0)
        return False


class MetricsWriter:
    """Per-step JSONL metrics for optimisation loops: one object a line,
    {"step", "ts", **metrics}."""

    def __init__(self, path):
        self.f = open(path, "a", buffering=1)

    def write(self, step, **metrics):
        self.f.write(json.dumps({"step": step, "ts": time.time(), **metrics}) + "\n")

    def close(self):
        self.f.close()
