"""Section wall-time accounting (TimerOutput equivalent — SURVEY.md §5.1).

RAII-style scopes accumulate per-section wall time and call counts; the
report matches the reference's iteration/end cadence controlled by
``Parameters::Timer``.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field


@dataclass
class SectionTimer:
    sections: dict[str, list] = field(default_factory=dict)  # name -> [t, n]

    @contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            ent = self.sections.setdefault(name, [0.0, 0])
            ent[0] += dt
            ent[1] += 1

    def report(self) -> str:
        if not self.sections:
            return ""
        total = sum(t for t, _ in self.sections.values())
        lines = ["+---------------------------------+------------+-------+",
                 "| Section                         |  wall time | calls |",
                 "+---------------------------------+------------+-------+"]
        for name, (t, n) in sorted(self.sections.items(),
                                   key=lambda kv: -kv[1][0]):
            lines.append(f"| {name:<31} | {t:9.3f}s  | {n:5d} |")
        lines.append(f"| {'TOTAL':<31} | {total:9.3f}s  |       |")
        lines.append("+---------------------------------+------------+-------+")
        return "\n".join(lines)

    def reset(self) -> None:
        self.sections.clear()

