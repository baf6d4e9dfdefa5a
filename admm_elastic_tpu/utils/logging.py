"""Convergence instrumentation (reference SolverLog, src/SolverLog.hpp).

The reference opt-in tracer records, per inner iteration, the normalized
error against a known solution x_star plus wall-clock, and the final
residual ||Ax - b||. The equivalent here runs the inner solver once with a
fixed iteration budget and returns the whole error trace as a device array
(a scan output), so tracing costs one extra solve rather than per-iteration
host sync.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass
class SolverLog:
    """Host-side collector with the reference's semantics."""

    x_star: np.ndarray | None = None
    errors: List[float] = dataclasses.field(default_factory=list)
    runtimes: List[float] = dataclasses.field(default_factory=list)
    final_r: float = 0.0
    _x0: np.ndarray | None = None

    def reset(self):
        self.errors = []
        self.runtimes = []
        self._x0 = None

    def add(self, x: np.ndarray, elapsed_ms: float = 0.0):
        if self.x_star is None or np.shape(self.x_star) != np.shape(x):
            return
        if not self.errors:
            self._x0 = np.array(x)
        numer = float(np.linalg.norm(self.x_star - x))
        denom = float(np.linalg.norm(self.x_star - self._x0))
        self.errors.append(numer / max(denom, 1e-300))
        self.runtimes.append(elapsed_ms)

    def finalize(self, A_mv, x, b):
        if self.x_star is None or np.shape(self.x_star) != np.shape(x):
            return
        self.final_r = float(np.linalg.norm(np.asarray(A_mv(x)) - np.asarray(b)))


@dataclasses.dataclass
class InnerLog:
    """Per-inner-iteration convergence curves for one step (SolverLog tier).

    One row per ADMM iteration (= one global solve), matching the
    reference's per-solve SolverLog records (src/SolverLog.hpp:36-60,
    hooked at src/NodalMultiColorGS.hpp:61,135,144 and
    src/UzawaCG.hpp:59,112,122). Residual definitions per solver:
    PCG ||b - A x_k||; GS ||b_eff - (A + C^T C) x_k|| per sweep;
    Uzawa ||C x_k - c|| (the Schur residual).
    """

    residuals: np.ndarray  # [admm_iters, n_inner]
    errors: "np.ndarray | None" = None  # same shape, vs x_star (if set)
    # Residual at the last inner iteration of the last solve, in the
    # active mode's residual definition above (NOT always ||A x - b||).
    final_r: float = 0.0
    x_star: "np.ndarray | None" = None  # set by the user before stepping


def admm_error_trace(solver, x_star: np.ndarray, n_steps: int = 1) -> np.ndarray:
    """Run n_steps and record per-ADMM-iteration normalized error vs x_star.

    Re-creates the reference's known-solution re-run workflow
    (src/SolverLog.hpp:36-55) at the ADMM-iteration granularity: run once to
    convergence to get x_star, then re-run calling this.
    """
    errors = []
    x0 = np.array(solver.x)
    denom = max(float(np.linalg.norm(x_star - x0)), 1e-300)
    saved_iters = solver.m_settings.admm_iters
    saved_verbose = solver.m_settings.verbose
    solver.m_settings.verbose = 0
    try:
        state0 = solver.state
        for it in range(1, saved_iters + 1):
            solver.state = state0
            solver.m_settings.admm_iters = it
            solver.step()
            errors.append(float(np.linalg.norm(x_star - solver.x)) / denom)
        solver.state = state0
        solver.m_settings.admm_iters = saved_iters
        solver.step()
    finally:
        solver.m_settings.admm_iters = saved_iters
        solver.m_settings.verbose = saved_verbose
    return np.asarray(errors)
