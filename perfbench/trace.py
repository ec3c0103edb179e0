"""The device trace of the traced calls: ``torch.profiler`` (CUPTI) over a
few calls of the measured path, exported as a Chrome trace and reduced to
the window, the seconds in which a kernel, copy or set ran on the device,
device time by kernel name, and the idle gaps labelled by the host
operation running at their middle."""
from __future__ import annotations

import bisect
import json
import re
from pathlib import Path

WINDOW = "perfbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
NO_OP = "host python between operations"
TOP = 10
# how far back a gap's label is looked for among earlier host events
LOOKBACK = 64


def profile(calls, out_path: Path) -> dict:
    """Run each of ``calls`` (no-argument callables) under the profiler,
    write the trace to ``out_path`` and return its reduction."""
    import torch
    from torch.profiler import ProfilerActivity, profile as _profile
    from torch.profiler import record_function
    torch.cuda.synchronize()
    with _profile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            for call in calls:
                call()
            torch.cuda.synchronize()
    out_path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out_path))
    with open(out_path) as f:
        events = json.load(f)["traceEvents"]
    return {**reduce(events), "calls": len(calls)}


def short(name: str) -> str:
    """A kernel's or operation's name without its namespace, return type
    and arguments."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"^void ", "", name)
    return name.split("(")[0][:80]


def _merge(spans):
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce(events: list) -> dict:
    """Window seconds, busy seconds, device seconds by kernel name, and
    the ``TOP`` device operations and idle-gap labels by seconds."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in xs if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        return {"window_s": 0.0, "busy_s": 0.0, "kernel_s": {},
                "device_ops": [], "idle_gaps": []}
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    spans, by_name, kernel_s = [], {}, {}
    for e in xs:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a = max(float(e["ts"]), w0)
        b = min(float(e["ts"]) + float(e["dur"]), w1)
        if b <= a:
            continue
        spans.append((a, b))
        name = short(e["name"])
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
        if e["cat"] == "kernel":
            kernel_s[e["name"]] = kernel_s.get(e["name"], 0.0) + (b - a) / 1e6
    busy = _merge(spans)
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e["name"]) for e in xs if e.get("cat") in HOST_CATS)
    starts = [h[0] for h in host]
    edges = [w0] + [v for ab in busy for v in ab] + [w1]
    gaps = {}
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        label = NO_OP
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - LOOKBACK, -1), -1):
            if host[j][1] >= mid:
                label = short(host[j][2])
                break
        gaps[label] = gaps.get(label, 0.0) + (b - a) / 1e6
    top = lambda d: [[k, v] for k, v in
                     sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {"window_s": (w1 - w0) / 1e6,
            "busy_s": sum(b - a for a, b in busy) / 1e6,
            "kernel_s": kernel_s, "device_ops": top(by_name),
            "idle_gaps": top(gaps)}
