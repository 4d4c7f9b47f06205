"""A ``torch.profiler`` window over a stretch of steady work.

The device intervals come from the profiler's raw kineto events, not
``prof.events()``, whose tree of Python objects takes tens of seconds to
build over ~10^5 launches (the pattern of ``chip_smoke.profile_window``,
copied).  Only the CUDA activity is traced: recording every aten op on
the host as well slows a host-bound loop (a batch-1 prefill on an H100
read 30-42 % idle under it, against 9-14 % with the CUDA activity
alone), so that the idle share would read the profiler's own cost.  The
window opens with a few spin kernels, kept out of every count, because a
late window was seen to lose its first device events.

What it gives: ``window_s`` (the host's clock over the work, ending in a
synchronize), ``busy_s`` (the union of device-operation intervals),
each device operation's count and seconds by name, and the longest idle
gaps, each named by the innermost host range that the CUDA activity
records (a CUDA runtime call, such as a launch or a synchronize) open
when the gap began.
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch

WARMUP_SPINS = 4
TOP = 10


def run(fn: Callable[[], object]) -> Dict:
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(WARMUP_SPINS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    device: List[Tuple[float, float, str]] = []
    host: List[Tuple[float, float, str]] = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        item = (start, start + e.duration_ns(), e.name())
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if "spin_kernel" not in item[2]:
                device.append(item)
        else:
            host.append(item)
    return summarize(device, host, window_s, out)


def summarize(device, host, window_s: float, out=None) -> Dict:
    device.sort()
    by_name: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    busy_ns, end, gaps = 0.0, None, []
    for start, stop, name in device:
        if end is not None and start > end:
            gaps.append((start - end, end))
        busy_ns += max(0.0, stop - (start if end is None else max(start, end)))
        end = stop if end is None else max(end, stop)
        by_name[name][0] += 1
        by_name[name][1] += (stop - start) / 1e9
    gaps.sort(reverse=True)
    host.sort()
    starts = [h[0] for h in host]
    named = []
    for length, at in gaps[:TOP]:
        named.append([_host_at(host, starts, at), length / 1e9])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    return {"window_s": window_s, "busy_s": busy_ns / 1e9,
            "n_device_ops": len(device),
            "ops": {k: (v[0], v[1]) for k, v in by_name.items()},
            "device_ops": [[k, v[1]] for k, v in ops[:TOP]],
            "idle_gaps": named, "out": out}


def _host_at(host, starts, t: float) -> str:
    """The innermost host range open at ``t``: the latest-starting one
    that contains it."""
    i = bisect.bisect_right(starts, t)
    best = None
    for j in range(i - 1, max(-1, i - 2000), -1):
        s, e, name = host[j]
        if e >= t:
            best = name
            break
    return best or "host (no range open)"


def kernel_seconds(prof: Dict, needle: str) -> Tuple[int, float]:
    """(count, seconds) of the device operations whose name holds
    ``needle``."""
    n, s = 0, 0.0
    for name, (c, sec) in prof["ops"].items():
        if needle in name:
            n, s = n + c, s + sec
    return n, s
