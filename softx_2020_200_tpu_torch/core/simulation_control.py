"""Host-side time/iteration control for steady and transient runs.

Equivalent of the reference's ``SimulationControl`` class
(``source/core/simulation_control.cc``, SURVEY.md §2.1): owns the current
time, the time-step history needed by variable-step BDF, the iteration
counter, CFL-adaptive dt scaling, BDF startup sub-step scaling, and
output/verbosity cadence.  Serializes to a plain dict for checkpointing.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .parameters import SimulationControlParams, TimeSteppingMethod


@dataclass
class SimulationControl:
    params: SimulationControlParams
    time: float = 0.0
    iteration: int = 0
    dt: float = 0.0
    # dt_history[0] = most recent completed step size
    dt_history: list[float] = field(default_factory=list)
    # CFL observed on the last completed step (set by the solver)
    cfl: float = 0.0

    def __post_init__(self) -> None:
        if self.dt == 0.0:
            self.dt = self.params.dt

    # ------------------------------------------------------------------
    @property
    def method(self) -> TimeSteppingMethod:
        return self.params.method

    def is_steady(self) -> bool:
        return self.method.is_steady

    def is_at_end(self) -> bool:
        if self.is_steady():
            return self.iteration >= 1
        return self.time >= self.params.time_end - 1e-12 * max(1.0, self.params.time_end)

    def integrate(self) -> None:
        """Advance to the next step: adapt dt, clip to end time, bump time."""
        if self.is_steady():
            self.iteration += 1
            return
        if self.params.adapt and self.iteration > 0 and self.cfl > 0.0:
            # scale dt toward max_cfl, capped by the adaptation scaling
            scale = min(self.params.adaptative_time_step_scaling,
                        self.params.max_cfl / self.cfl)
            self.dt = self.dt * scale
        # never step past the end time
        if self.time + self.dt > self.params.time_end:
            self.dt = self.params.time_end - self.time
        self.time += self.dt
        self.iteration += 1
        self.dt_history.insert(0, self.dt)
        del self.dt_history[4:]

    # ------------------------------------------------------------------
    def effective_bdf_order(self) -> int:
        """BDF order usable at this step (startup ramps 1 -> target order)."""
        target = self.method.bdf_order
        if target == 0:
            return 0
        return min(target, len(self.dt_history))

    def dts(self) -> np.ndarray:
        return np.asarray(self.dt_history, dtype=np.float64)

    def is_output_iteration(self) -> bool:
        f = self.params.output_frequency
        if f <= 0:
            return False
        return self.iteration % f == 0

    def is_verbose_iteration(self) -> bool:
        return True

    # ------------------------------------------------------------------
    def serialize(self) -> dict:
        return {
            "time": self.time,
            "iteration": self.iteration,
            "dt": self.dt,
            "dt_history": list(self.dt_history),
            "cfl": self.cfl,
        }

    def deserialize(self, state: dict) -> None:
        self.time = float(state["time"])
        self.iteration = int(state["iteration"])
        self.dt = float(state["dt"])
        self.dt_history = [float(x) for x in state["dt_history"]]
        self.cfl = float(state.get("cfl", 0.0))
