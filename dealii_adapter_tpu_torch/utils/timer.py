"""Section wall timers — the `TimerOutput` capability of the reference
(`linear_elasticity.cc:63` + enter/leave_subsection sites; summary printed
at program end). Use as a context manager around host-side sections; device
work inside a section should end with `torch.cuda.synchronize()` for honest
accounting (asynchronous launches otherwise attribute device time to the
next sync point). A copy of the JAX package's `utils/timer.py`.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict


class TimerOutput:
    def __init__(self, name: str = ""):
        self.name = name
        self.sections: Dict[str, list] = {}  # name -> [total_s, calls]
        self._t0 = time.perf_counter()

    @contextmanager
    def section(self, name: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            rec = self.sections.setdefault(name, [0.0, 0])
            rec[0] += time.perf_counter() - start
            rec[1] += 1

    def total(self) -> float:
        return time.perf_counter() - self._t0

    def summary(self) -> str:
        total = self.total()
        lines = [
            "+---------------------------------------------+------------"
            "+------------+",
            f"| Total wallclock time elapsed since start    | {total:9.3g}s "
            "|            |",
            "| Section                         | no. calls |  wall time "
            "| % of total |",
            "+---------------------------------+-----------+------------"
            "+------------+",
        ]
        for name, (secs, calls) in sorted(self.sections.items()):
            pct = 100.0 * secs / total if total > 0 else 0.0
            lines.append(
                f"| {name:<31} | {calls:9d} | {secs:9.3g}s | {pct:9.3g}% |"
            )
        lines.append(
            "+---------------------------------+-----------+------------"
            "+------------+"
        )
        return "\n".join(lines)

    def print_summary(self) -> None:
        print(self.summary())
