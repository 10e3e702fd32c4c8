"""Tracing / profiling helpers (SURVEY §5: the reference has none — its
diagnostics are cout pose dumps, reference src/odom_run.cpp:111-112).

Wraps jax.profiler for device traces viewable in XProf/TensorBoard, plus a
lightweight host-side stage timer for the runner loop.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator

import jax


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[None]:
    """Capture a device trace: `with device_trace("/tmp/trace"): step(...)`."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named region that shows up in the device trace."""
    return jax.profiler.TraceAnnotation(name)


class StageTimer:
    """Accumulating host-side stage timer.

    with timer.stage("preprocess"): ...
    print(timer.report())
    """

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, n = self.totals[name], self.counts[name]
            lines.append(f"{name:30s} {t:8.3f}s total  {t / max(n, 1) * 1e3:8.2f}ms avg  x{n}")
        return "\n".join(lines)


def block_and_time(fn, *args, repeats: int = 10, **kw):
    """Wall-clock a jitted callable (post-warmup), returns seconds/call."""
    out = fn(*args, **kw)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(repeats):
        out = fn(*args, **kw)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / repeats


def trace_device_summary(log_dir: str, device: str = "GPU", top: int = 25):
    """Reduce a `jax.profiler.trace(log_dir, create_perfetto_trace=True)`
    capture to device metrics: the window (first to last device event),
    busy time (union of the device's op intervals), idle share
    (1 - busy / window), and the `top` ops by summed device time.

    Returns a dict; times in microseconds."""
    import collections
    import glob
    import gzip
    import json

    files = sorted(glob.glob(f"{log_dir}/**/perfetto_trace.json.gz",
                             recursive=True))
    if not files:
        raise FileNotFoundError(f"no perfetto trace under {log_dir}")
    with gzip.open(files[-1]) as fh:
        trace = json.load(fh)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    names = {
        e["pid"]: e.get("args", {}).get("name", "")
        for e in events
        if e.get("ph") == "M" and e.get("name") == "process_name"
    }
    pids = {p for p, n in names.items() if device in n}
    ops = [e for e in events
           if e.get("ph") == "X" and e.get("pid") in pids and e.get("dur")]
    if not ops:
        raise ValueError(f"no {device} events in {files[-1]}")
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in ops)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
    per_op = collections.Counter()
    count = collections.Counter()
    for e in ops:
        per_op[e["name"]] += float(e["dur"])
        count[e["name"]] += 1
    return {
        "window_us": window,
        "busy_us": busy,
        "idle_share": 1.0 - busy / window if window > 0 else 0.0,
        "n_ops": len(ops),
        "top": [(n, d, count[n]) for n, d in per_op.most_common(top)],
    }
