"""The traced window: frames under ``torch.profiler`` (CPU and CUDA
activity), and what its trace says.

The reading follows ``chip_smoke.py`` ``profile_device`` (one window under
the profiler, synchronised at its end, the profiler's overhead in the
host time), from the exported trace's events rather than the averages,
so that the device's busy time is the union of its operations'
intervals and the idle gaps can be named.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
import warnings
from collections import defaultdict
from types import SimpleNamespace

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
TOP = 10
NAME = 120      # characters kept of an operation's or a span's name


def profile_frames(frame, n: int, dev: torch.device) -> SimpleNamespace:
    """``frame()`` n times under the profiler, each in a ``bench.frame``
    span -> the trace's summary (``summarize``)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(dev)
    with warnings.catch_warnings():
        # torch warns that a second profiling cycle would clear the events.
        warnings.simplefilter("ignore", UserWarning)
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                with record_function("bench.frame"):
                    frame()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            window_s = time.perf_counter() - t0
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
    return summarize(events, n, window_s)


def _spans(events, cats):
    return [e for e in events if e.get("ph") == "X" and e.get("cat") in cats]


def _innermost(host, ts: float) -> str:
    """The name of the shortest host span that holds time ``ts``."""
    best = None
    for e in host:
        if e["ts"] <= ts <= e["ts"] + e["dur"]:
            if best is None or e["dur"] < best["dur"]:
                best = e
    return best["name"][:NAME] if best else "(no host span)"


def summarize(events, frames: int, window_s: float) -> SimpleNamespace:
    """A trace's device operations -> busy seconds (the union of their
    intervals), kernel launches, each kernel's (name, seconds), and the
    breakdown: the device operations that took most time, and the longest
    idle gaps of the device, each named by the host span innermost around
    the launch of the operation that ended it."""
    dev_ops = sorted(_spans(events, DEVICE_CATS), key=lambda e: e["ts"])
    host = _spans(events, HOST_CATS)
    launch_ts = {e["args"]["correlation"]: e["ts"]
                 for e in _spans(events, LAUNCH_CATS)
                 if "correlation" in e.get("args", {})}
    busy_us = 0.0
    gaps = []
    end = None
    for e in dev_ops:
        s, t = e["ts"], e["ts"] + e["dur"]
        if end is None or s > end:
            if end is not None:
                gaps.append((s - end, e))
            busy_us += e["dur"]
            end = t
        elif t > end:
            busy_us += t - end
            end = t
    by_name = defaultdict(float)
    for e in dev_ops:
        by_name[e["name"][:NAME]] += e["dur"] / 1e6
    gaps.sort(key=lambda g: -g[0])
    idle = []
    for length, e in gaps[:TOP]:
        corr = e.get("args", {}).get("correlation")
        ts = launch_ts.get(corr, e["ts"])
        idle.append([_innermost(host, ts), length / 1e6])
    kernels = [(e["name"], e["dur"] / 1e6) for e in dev_ops
               if e["cat"] == "kernel"]
    return SimpleNamespace(
        frames=frames, window_s=window_s, busy_s=busy_us / 1e6,
        launches=len(kernels), kernels=kernels,
        breakdown={"device_ops": [[k, v] for k, v in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:TOP]],
            "idle_gaps": idle})
