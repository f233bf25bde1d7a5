"""ParaView .pvd time-series bookkeeping.

Equivalent of the reference's ``PVDHandler`` (``source/core/pvd_handler.cc``,
SURVEY.md §2.1): accumulates (time, vtu-file) pairs, writes the ``.pvd``
master file, and serializes itself so the time series survives a restart.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field


@dataclass
class PVDHandler:
    entries: list[tuple[float, str]] = field(default_factory=list)

    def append(self, time: float, filename: str) -> None:
        self.entries.append((float(time), filename))

    def write(self, path: str) -> None:
        lines = [
            '<?xml version="1.0"?>',
            '<VTKFile type="Collection" version="0.1" byte_order="LittleEndian">',
            '  <Collection>',
        ]
        for t, fn in self.entries:
            lines.append(
                f'    <DataSet timestep="{t:.12g}" group="" part="0" file="{fn}"/>')
        lines += ['  </Collection>', '</VTKFile>', '']
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as fh:
            fh.write("\n".join(lines))

    def serialize(self) -> dict:
        return {"entries": [[t, fn] for t, fn in self.entries]}

    def deserialize(self, state: dict) -> None:
        self.entries = [(float(t), str(fn)) for t, fn in state["entries"]]
