"""Arithmetic over the device trace of a stretch of the window (copied
from the program's `chip_smoke.py:profile_timeline`): the busy union of
the device's kernels and copies, device time by kernel name, and the idle
gaps, each named by the device operation it follows (a device-to-host copy
is a read-back: the gap after it is the host's turn-around)."""

from __future__ import annotations

import re


class DeviceTrace:
    """`events`: (start_us, end_us, name) of the device's activity over a
    stretch of `wall_s` seconds (host clock, synchronised at both ends)."""

    def __init__(self, events, wall_s: float):
        self.events = sorted(events, key=lambda e: e[0])
        self.wall_s = float(wall_s)
        busy, end, last = 0.0, None, None
        gaps = []
        for t0, t1, name in self.events:
            if end is not None and t0 > end:
                gaps.append((t0 - end, last))
            if end is None or t0 > end:
                busy += t1 - t0
                end, last = t1, name
            elif t1 > end:
                busy += t1 - end
                end, last = t1, name
        self.busy_s = busy / 1e6
        self.gaps = gaps
        self.by_name = {}
        for t0, t1, name in self.events:
            self.by_name[name] = self.by_name.get(name, 0.0) + (t1 - t0) / 1e6

    def seconds_matching(self, patterns) -> float:
        """Device seconds of the operations whose name matches any of the
        regular expressions."""
        rx = [re.compile(p) for p in patterns]
        return sum(s for n, s in self.by_name.items()
                   if any(r.search(n) for r in rx))

    def breakdown(self, k: int = 10) -> dict:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:k]
        by_after = {}
        for gap_us, after in self.gaps:
            label = ("after a read-back" if after.startswith("Memcpy DtoH")
                     else "after " + after[:80])
            by_after[label] = by_after.get(label, 0.0) + gap_us / 1e6
        gaps = sorted(by_after.items(), key=lambda kv: -kv[1])[:k]
        return {"device_ops": [[n[:120], s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gaps]}


def record(profiler) -> list:
    """The device events of a finished `torch.profiler.profile`."""
    from torch.autograd import DeviceType

    return [(e.time_range.start, e.time_range.end, e.name)
            for e in profiler.events() if e.device_type == DeviceType.CUDA]
