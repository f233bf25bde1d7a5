"""Text tables (TableHandler equivalent — SURVEY.md §5.5).

The reference writes forces/torques/KE/enstrophy/L2-error series as
aligned text tables (``force.<bc>.dat`` etc.) that its golden tests diff.
Same here: column-ordered, fixed precision, space-aligned.
"""

from __future__ import annotations

import os


class Table:
    def __init__(self, columns: list[str], precision: int = 6):
        self.columns = columns
        self.precision = precision
        self.rows: list[list] = []

    def add_row(self, values) -> None:
        if isinstance(values, dict):
            values = [values[c] for c in self.columns]
        if len(values) != len(self.columns):
            raise ValueError("row length mismatch")
        self.rows.append(list(values))

    def _fmt(self, v) -> str:
        if isinstance(v, bool):
            return str(v)
        if isinstance(v, int):
            return str(v)
        if isinstance(v, float):
            return f"{v:.{self.precision}e}"
        return str(v)

    def render(self) -> str:
        cells = [[self._fmt(v) for v in row] for row in self.rows]
        widths = [max(len(c), *(len(r[i]) for r in cells)) if cells
                  else len(c) for i, c in enumerate(self.columns)]
        lines = [" ".join(c.rjust(w) for c, w in zip(self.columns, widths))]
        for r in cells:
            lines.append(" ".join(v.rjust(w) for v, w in zip(r, widths)))
        return "\n".join(lines) + "\n"

    def write(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as fh:
            fh.write(self.render())
