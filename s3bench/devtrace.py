"""The card's activity over the window, from ``torch.profiler``.

Only device activity is recorded (CUPTI: kernels, copies and memsets of
every thread, including the kernels the port launches through ctypes).
The trace is exported to the run's scratch directory and read back:
every device operation with its start and duration.
"""

from __future__ import annotations

import json
import os
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class DeviceTrace:
    def __init__(self, scratch: str):
        self.path = os.path.join(scratch, "device_trace.json")
        self.prof = None
        self.t0 = 0.0
        self.window_s = 0.0
        self.ops: list[tuple[str, float, float, str]] = []  # (name, start_s, dur_s, cat)

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.monotonic()

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.window_s = time.monotonic() - self.t0
        self.prof.__exit__(None, None, None)
        self.prof.export_chrome_trace(self.path)
        with open(self.path) as f:
            events = json.load(f).get("traceEvents", [])
        os.remove(self.path)
        self.ops = sorted(
            (e.get("name", "?"), e["ts"] / 1e6, e.get("dur", 0) / 1e6, e["cat"]) for e in events
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS)

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the card (the union)."""
        busy, end = 0.0, None
        for _, s, d, _ in sorted(self.ops, key=lambda o: o[1]):
            e = s + d
            if end is None or s >= end:
                busy += d
                end = e
            elif e > end:
                busy += e - end
                end = e
        return busy

    def kernel_s(self, *names: str) -> float:
        """Summed device time of the kernels whose name holds any of
        ``names``; of every kernel where none is given."""
        return sum(d for n, _, d, c in self.ops if c == "kernel"
                   and (not names or any(x in n for x in names)))

    def breakdown(self, top: int = 10) -> dict:
        """The operations that took most time, and the longest gaps
        between operations, each named by the operation that ended it."""
        by: dict[str, float] = {}
        for n, _, d, _ in self.ops:
            by[n[:120]] = by.get(n[:120], 0.0) + d
        gaps = []
        ops = sorted(self.ops, key=lambda o: o[1])
        end = None
        for n, s, d, _ in ops:
            if end is not None and s > end:
                gaps.append((f"idle before {n[:100]}", s - end))
            end = s + d if end is None else max(end, s + d)
        return {"device_ops": [[n, t] for n, t in sorted(by.items(), key=lambda x: -x[1])[:top]],
                "idle_gaps": [[n, t] for n, t in sorted(gaps, key=lambda x: -x[1])[:top]]}
