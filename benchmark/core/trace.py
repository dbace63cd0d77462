"""The traced window: torch.profiler over the window, reduced to the
device's busy time, each kernel's time and launches, and the idle gaps by
what the host was doing.

The busy time is the union of the device's operations' intervals (kernels,
copies and sets) inside the window, as ``chip_smoke.py:busy_share`` takes
the union of the kernels' (copied, not imported).  The window is the
harness's own ``bench.window`` annotation.  An idle gap is named by the
harness span that held the host then (``bench.dispatch``: the call into
the program; ``bench.finish``: the wait for its output) and the longest
host operation of the program under it, if any.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "bench."


class Profiler:
    """torch.profiler (host and device activity) written to a temporary
    Chrome trace, read back and deleted by reduce()."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._dir = tempfile.mkdtemp(prefix="bench_trace_")

    def start(self):
        self._prof.start()

    def stop(self):
        self._prof.stop()

    def events(self) -> list:
        path = os.path.join(self._dir, "trace.json")
        self._prof.export_chrome_trace(path)
        try:
            with open(path) as f:
                return json.load(f)["traceEvents"]
        finally:
            shutil.rmtree(self._dir, ignore_errors=True)


def _union(spans):
    """Sorted (start, end) pairs -> merged pairs."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _short(name: str, n: int = 110) -> str:
    """A kernel's or an operation's name without its namespaces and its
    argument list, cut to n characters."""
    for junk in ("void ", "at::native::", "(anonymous namespace)::", "std::"):
        name = name.replace(junk, "")
    cut = name.find(">(")
    if cut > 0:
        name = name[:cut + 1]
    elif name.find("(") > 0 and "<" not in name[:name.find("(")]:
        name = name[:name.find("(")]
    return name[:n]


def _index(evs, bucket: float = 1000.0):
    """-> fn(t) -> the events of `evs` whose interval holds t (µs), through
    buckets of `bucket` µs."""
    grid = defaultdict(list)
    for e in evs:
        a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
        for i in range(int(a // bucket), int(b // bucket) + 1):
            grid[i].append(e)

    def at(t):
        return [e for e in grid.get(int(t // bucket), ())
                if e["ts"] <= t <= e["ts"] + e.get("dur", 0)]
    return at


def reduce(events: list) -> dict:
    """-> {"busy_s", "window_s", "kernels": {name: [launches, seconds]},
    "device_ops": [[name, s]] (top 10), "idle_gaps": [[name, s]] (top 10)}
    over the ``bench.window`` annotation."""
    xs = [e for e in events if e.get("ph") == "X" and "ts" in e]
    win = [e for e in xs if e.get("name") == SPAN_PREFIX + "window"]
    if not win:
        raise RuntimeError("the trace has no bench.window span")
    lo = float(win[0]["ts"])
    hi = lo + float(win[0]["dur"])
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS]
    spans = _union((max(float(e["ts"]), lo),
                    min(float(e["ts"]) + float(e.get("dur", 0)), hi))
                   for e in dev if float(e["ts"]) < hi
                   and float(e["ts"]) + float(e.get("dur", 0)) > lo)
    busy = sum(b - a for a, b in spans)
    kernels = defaultdict(lambda: [0, 0.0])
    ops = defaultdict(float)
    for e in dev:
        d = float(e.get("dur", 0)) * 1e-6
        ops[_short(e["name"])] += d
        if e.get("cat") == "kernel":
            k = kernels[e["name"]]
            k[0] += 1
            k[1] += d
    # idle gaps inside the window, named by the host's work at their middle
    harness = [e for e in xs if str(e.get("name", "")).startswith(SPAN_PREFIX)
               and e["name"] != SPAN_PREFIX + "window"]
    host_ops = [e for e in xs if e.get("cat") in ("cpu_op", "user_annotation",
                                                  "python_function")
                and not str(e.get("name", "")).startswith(SPAN_PREFIX)]
    at_harness, at_host = _index(harness), _index(host_ops)
    gaps = defaultdict(float)
    edges = [lo] + [x for ab in spans for x in ab] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        span = max(at_harness(mid), key=lambda e: -e["dur"], default=None)
        name = "other" if span is None else span["name"][len(SPAN_PREFIX):]
        under = at_host(mid)
        if under:
            name += " / " + _short(max(under, key=lambda e: e["dur"])["name"],
                                   64)
        gaps[name] += (b - a) * 1e-6
    top = lambda d: [[k, v] for k, v in sorted(d.items(),
                                               key=lambda kv: -kv[1])[:10]]
    return dict(busy_s=busy * 1e-6, window_s=(hi - lo) * 1e-6,
                kernels=dict(kernels), device_ops=top(ops),
                idle_gaps=top(gaps))


def kernel_time(kernels: dict, *names) -> tuple:
    """(launches, seconds) of every kernel whose name holds one of
    `names`."""
    n, s = 0, 0.0
    for k, (c, t) in kernels.items():
        if any(x in k for x in names):
            n += c
            s += t
    return n, s
