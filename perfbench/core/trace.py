"""The traced stretch: spans around port functions, one profiler window,
and its reduction to device time by span, busy time and idle gaps.

``spans.json`` names, for each span, the dotted path of a port function
(``module.Class.method`` or ``module.function``).  While the stretch runs,
each is replaced by a wrapper that opens a ``torch.profiler.
record_function`` range ``span.<name>`` and records the shapes of its
tensor arguments.  A kernel belongs to a span when the host call that
launched it (matched by the profiler's correlation id, runtime or driver
API, so the ``ctypes`` launches of the hand-written kernels count too)
lies inside one of the span's ranges on the same thread.  The trace is
written to ``TMPDIR``, read back and deleted.
"""

from __future__ import annotations

import bisect
import importlib
import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW = "perfbench.window"


def _resolve(path: str):
    """(owner, attribute) of a dotted path: the longest importable module
    prefix, then attributes."""
    parts = path.split(".")
    for cut in range(len(parts) - 1, 0, -1):
        try:
            owner = importlib.import_module(".".join(parts[:cut]))
        except ImportError:
            continue
        for name in parts[cut:-1]:
            owner = getattr(owner, name)
        return owner, parts[-1]
    raise ImportError(f"cannot resolve {path!r}")


class Spans:
    """Installs and removes the span wrappers."""

    def __init__(self, spec: Dict[str, str]):
        self.spec = spec
        self.calls: Dict[str, List[Tuple]] = defaultdict(list)
        self._saved = []

    def install(self) -> None:
        for name, path in self.spec.items():
            owner, attr = _resolve(path)
            orig = owner.__dict__[attr] if isinstance(owner, type) else getattr(owner, attr)
            setattr(owner, attr, self._wrap(name, orig))
            self._saved.append((owner, attr, orig))

    def _wrap(self, name: str, fn: Callable) -> Callable:
        calls = self.calls[name]

        def wrapper(*args, **kwargs):
            calls.append(tuple(tuple(a.shape) for a in args if isinstance(a, torch.Tensor)))
            with torch.profiler.record_function("span." + name):
                return fn(*args, **kwargs)
        wrapper.__wrapped__ = fn
        return wrapper

    def remove(self) -> None:
        for owner, attr, orig in reversed(self._saved):
            setattr(owner, attr, orig)
        self._saved = []


@dataclass
class Reduced:
    window_s: float
    busy_s: float
    span_device_s: Dict[str, float]
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]
    unattributed_s: float = 0.0
    kernels: int = 0


def profile(run: Callable[[], None]) -> dict:
    """Run ``run`` under the profiler inside a ``perfbench.window`` range;
    returns the chrome trace as a dict."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            torch.cuda.synchronize()
            run()
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            return json.load(fh)
    finally:
        os.remove(path)


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def reduce(trace: dict, top: int = 10) -> Reduced:
    """Device time by span, busy time, the top device ops and idle gaps of
    the ``perfbench.window`` range (trace times are microseconds)."""
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    win = [e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError("the trace holds no perfbench.window range")
    w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and w0 <= e["ts"] <= w1]
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    ranges: Dict[Tuple[str, object], List[Tuple[float, float]]] = defaultdict(list)
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"].startswith("span."):
            ranges[(e["name"][5:], e["tid"])].append((e["ts"], e["ts"] + e["dur"]))
    starts = {k: [a for a, _ in sorted(v)] for k, v in ranges.items()}
    ranges = {k: sorted(v) for k, v in ranges.items()}

    span_s: Dict[str, float] = defaultdict(float)
    by_name: Dict[str, float] = defaultdict(float)
    unattributed = 0.0
    for e in dev:
        d = e["dur"] * 1e-6
        by_name[e["name"][:160]] += d
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is None:
            unattributed += d
            continue
        t = launch["ts"]
        for (name, tid), rs in ranges.items():
            if tid != launch["tid"]:
                continue
            j = bisect.bisect_right(starts[(name, tid)], t) - 1
            if j >= 0 and rs[j][0] <= t <= rs[j][1]:
                span_s[name] += d

    busy = _merge([(max(e["ts"], w0), min(e["ts"] + e["dur"], w1)) for e in dev])
    busy_s = sum(b - a for a, b in busy) * 1e-6
    gaps = []
    prev = w0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if w1 > prev:
        gaps.append((prev, w1))
    host = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("tid") == win[0]["tid"] and e.get("cat") in (
                       "cpu_op", "user_annotation", *LAUNCH_CATS) and e["name"] != WINDOW),
                  key=lambda x: x[0])
    host_starts = [h[0] for h in host]
    gap_by: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        j = bisect.bisect_right(host_starts, a) - 1
        label = "host outside any op"
        for k in range(j, max(j - 2000, -1), -1):
            if host[k][1] > a:
                label = host[k][2][:160]
                break
        gap_by[label] += (b - a) * 1e-6
    rank = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]
    return Reduced(window_s=(w1 - w0) * 1e-6, busy_s=busy_s, span_device_s=dict(span_s),
                   device_ops=rank(by_name), idle_gaps=rank(gap_by),
                   unattributed_s=unattributed, kernels=len(dev))
