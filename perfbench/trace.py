"""Reading a profiler trace (the Chrome trace JSON that ``torch.profiler``
exports): the device's operations, the host's annotated spans, and which
span each kernel was launched from (through the launch's correlation id).
Timestamps are microseconds on one clock for host and device.
"""
from __future__ import annotations

import bisect
import collections
import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
STEP = "ServeEngine.step"


class Trace:
    def __init__(self, events: list):
        self.ops = []            # (ts, end, name, correlation) on the device
        launches = {}
        spans = []
        for ev in events:
            if ev.get("ph") != "X":
                continue
            cat = ev.get("cat", "")
            ts, dur = float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0))
            if cat in DEVICE_CATS:
                self.ops.append((ts, ts + dur, ev.get("name", ""),
                                 ev.get("args", {}).get("correlation"),
                                 cat))
            elif cat in LAUNCH_CATS:
                corr = ev.get("args", {}).get("correlation")
                if corr is not None:
                    launches[corr] = ts
            elif cat == "user_annotation":
                spans.append((ts, ts + dur, ev.get("name", "")))
        self.ops.sort(key=lambda op: (op[0], op[1]))
        self.launch_ts = launches
        self.spans = sorted(spans)
        self._starts = [s[0] for s in self.spans]
        steps = [s for s in self.spans if s[2] == STEP]
        self.t0 = steps[0][0] if steps else None
        self.t1 = max(s[1] for s in steps) if steps else None
        self._kernels = None

    @classmethod
    def load(cls, path) -> "Trace":
        with open(path) as f:
            data = json.load(f)
        events = data["traceEvents"] if isinstance(data, dict) else data
        return cls(events)

    @property
    def span_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6 if self.t0 is not None else 0.0

    def kernels(self) -> list:
        """Device kernels (not copies) inside the traced steps."""
        if self._kernels is None:
            self._kernels = [op for op in self.ops
                             if op[4] == "kernel" and self._inside(op)]
        return self._kernels

    def _inside(self, op) -> bool:
        return self.t0 is not None and op[0] >= self.t0 and op[0] < self.t1

    def host_span(self, t: float) -> str:
        """The innermost annotated span open on the host at time t."""
        for j in range(bisect.bisect_right(self._starts, t) - 1, -1, -1):
            _, end, name = self.spans[j]
            if end >= t:
                return name          # the latest-started span holding t
            if name == STEP:
                break                # steps are outermost and in sequence
        return "outside any step"

    def label(self, op) -> str:
        """The span a device op was launched from (by its launch's host
        time), or "unlaunched" where the trace lost the launch."""
        ts = self.launch_ts.get(op[3])
        return "unlaunched" if ts is None else self.host_span(ts)

    def busy_intervals(self) -> list:
        """The union of device-op intervals, clipped to the traced steps."""
        out = []
        for ts, end, *_ in self.ops:
            ts, end = max(ts, self.t0), min(end, self.t1)
            if end <= ts:
                continue
            if out and ts <= out[-1][1]:
                out[-1][1] = max(out[-1][1], end)
            else:
                out.append([ts, end])
        return out

    def busy_s(self) -> float:
        if self.t0 is None:
            return 0.0
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def idle_gaps(self) -> list:
        """(start, end) of every stretch of the traced steps with no
        device op running."""
        gaps, t = [], self.t0
        for s, e in self.busy_intervals():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if self.t0 is not None and self.t1 > t:
            gaps.append((t, self.t1))
        return gaps

    def device_time(self, match) -> float:
        """Seconds of the traced kernels for which ``match(op, label)``."""
        return sum(op[1] - op[0] for op in self.kernels()
                   if match(op, self.label(op))) * 1e-6

    def count(self, needle: str) -> int:
        return sum(1 for op in self.kernels() if needle in op[2])

    def breakdown(self, n: int = 10) -> dict:
        """The device ops that took the most time, and the idle time by
        what the host was doing, each list at most ``n`` long."""
        by_op = collections.Counter()
        for op in self.ops:
            if self._inside(op):
                by_op[op[2][:160]] += (op[1] - op[0]) * 1e-6
        by_host = collections.Counter()
        for s, e in self.idle_gaps():
            by_host[self.host_span((s + e) / 2)] += (e - s) * 1e-6
        return {"device_ops": [[k, v] for k, v in by_op.most_common(n)],
                "idle_gaps": [[k, v] for k, v in by_host.most_common(n)]}
