"""A profiled slice reduced to what the per-layer metrics read: the device's
busy time (the union of its activities), each kernel's device time and
activity count, the device operations that took most time, and the
longest idle gaps by what the host was doing meanwhile."""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import numpy as np


def union_s(intervals: List[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals (same unit)."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def gaps(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The holes between the merged intervals, in order."""
    out, end = [], None
    for a, b in sorted(intervals):
        if end is not None and a > end:
            out.append((end, a))
        end = b if end is None else max(end, b)
    return out


def reduce_events(device: List[Tuple[str, float, float]],
                  host: List[Tuple[str, float, float]],
                  symbols: Mapping[str, str], max_gaps: int = 200) -> Dict:
    """device / host: (name, start_us, end_us) activities. Returns
    {busy_s, kernel_s {name: s}, kernel_count {name: n}, device_ops
    [[name, s]] (top 10 by summed time), idle_gaps [[host op, s]] (top 10
    by summed gap time, over the `max_gaps` longest gaps)}."""
    busy = union_s([(a, b) for _, a, b in device]) / 1e6
    kernel_s = {k: 0.0 for k in symbols}
    kernel_count = {k: 0 for k in symbols}
    by_name: Dict[str, float] = {}
    for name, a, b in device:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
        for k, sym in symbols.items():
            if sym in name:
                kernel_s[k] += (b - a) / 1e6
                kernel_count[k] += 1
    idle: Dict[str, float] = {}
    holes = sorted(gaps([(s, e) for _, s, e in device]),
                   key=lambda g: g[0] - g[1])[:max_gaps]
    if holes and host:
        starts = np.array([h[1] for h in host])
        ends = np.array([h[2] for h in host])
        for a, b in holes:
            mid = 0.5 * (a + b)
            inside = np.flatnonzero((starts <= mid) & (ends >= mid))
            name = (host[inside[np.argmin(ends[inside] - starts[inside])]][0]
                    if inside.size else "(no host op)")
            idle[name] = idle.get(name, 0.0) + (b - a) / 1e6
    top = lambda d: [[n, s] for n, s in sorted(d.items(),
                                               key=lambda kv: -kv[1])[:10]]
    return {"busy_s": busy, "kernel_s": kernel_s,
            "kernel_count": kernel_count, "device_ops": top(by_name),
            "idle_gaps": top(idle)}


def profile_events(prof) -> Tuple[List, List]:
    """(device, host) activities of a finished torch.profiler.profile."""
    import torch
    device, host = [], []
    for e in prof.events():
        item = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == torch.autograd.DeviceType.CUDA:
            device.append(item)
        else:
            host.append(item)
    return device, host
