"""SolverLog-tier inner-iteration convergence traces (reference
src/SolverLog.hpp:36-64, hooked into every LinearSolver::solve at
src/NodalMultiColorGS.hpp:61,135,144 and src/UzawaCG.hpp:59,112,122).

The redesign records the whole curve as fixed-length scan outputs
from one run (solver.step_logged / Settings.log_inner) instead of
per-iteration host callbacks.
"""

import numpy as np

from tests.test_contact import drop_box_solver
from tests.test_parallel import _small_solver


def test_pcg_residual_trace_decreases():
    s = _small_solver()  # linsolver=3
    s.m_settings.log_inner = True
    s.m_settings.log_inner_iters = 30
    log = s.step_logged()
    r = log.residuals
    assert r.shape == (s.m_settings.admm_iters, 30)
    assert np.isfinite(r).all()
    # CG residuals are not iteration-monotone (only the A-norm error is);
    # the curve must still fall to the noise floor by the end.
    assert np.all(r[:, -1] <= 1e-6 * r[:, 0] + 1e-12)
    # finalize()-equivalent: ||A x - b|| after the last solve.
    assert log.final_r < 1e-8


def test_gs_residual_trace_decreases():
    g = drop_box_solver(linsolver=1)
    g.m_settings.log_inner = True
    g.m_settings.log_inner_iters = 20
    for _ in range(12):  # reach floor contact first
        g.step()
    log = g.step_logged()
    r = log.residuals
    assert r.shape == (g.m_settings.admm_iters, 20)
    assert np.isfinite(r).all()
    # The constrained solution does NOT satisfy A x = b_eff at contact
    # nodes (the per-node projection overrides the linear update), so each
    # row floors at the projection-equilibrium residual instead of zero.
    # The first solve (far from equilibrium) must fall hard; later rows
    # start at the floor and must stay bounded.
    assert r[0, -1] < 0.1 * r[0, 0]
    assert np.all(r[:, -1] <= 1.1 * r[:, 0] + 1e-9)


def test_uzawa_residual_trace_monotone():
    u = drop_box_solver(linsolver=2)
    u.m_settings.log_inner = True
    u.m_settings.log_inner_iters = 12
    for _ in range(12):
        u.step()
    log = u.step_logged()
    r = log.residuals
    assert r.shape == (u.m_settings.admm_iters, 12)
    assert np.isfinite(r).all()
    # The Schur residual is monotone non-increasing down to noise.
    assert np.all(np.diff(r, axis=1) <= 1e-12 + 0.5 * r[:, :-1])
    assert np.all(r[:, -1] <= r[:, 0] + 1e-15)
    # At least one step had active contacts to trace.
    assert r.max() > 0


def test_alpcg_residual_trace_decreases():
    a = drop_box_solver(linsolver=4)
    a.m_settings.log_inner = True
    a.m_settings.log_inner_iters = 25
    for _ in range(12):
        a.step()
    log = a.step_logged()
    r = log.residuals
    assert r.shape == (a.m_settings.admm_iters, 25)
    assert np.isfinite(r).all()
    # One PCG solve on A + C^T C per iteration: falls to the noise floor.
    nz = r[:, 0] > 1e-12
    assert np.all(r[nz, -1] <= 1e-4 * r[nz, 0] + 1e-10)


def test_error_vs_known_solution_curve():
    """The reference workflow: run once to convergence for x_star, re-run
    with SolverLog attached (src/SolverLog.hpp:36-55)."""
    ref = _small_solver()
    ref.m_settings.admm_iters = 200
    ref.step()
    x_star = ref.x

    s = _small_solver()
    s.solver_log.x_star = x_star
    s.m_settings.log_inner = True
    s.m_settings.log_inner_iters = 30
    s.m_settings.admm_iters = 40
    log = s.step_logged()
    assert log.errors is not None
    assert log.errors.shape == log.residuals.shape
    assert np.isfinite(log.errors).all()
    # Across ADMM iterations the end-of-solve error approaches x_star.
    assert log.errors[-1, -1] < 0.5 * log.errors[0, 0]


def test_log_inner_flag_routes_step():
    s = _small_solver()
    s.m_settings.log_inner = True
    s.m_settings.log_inner_iters = 10
    s.step()  # routes through step_logged
    assert s.solver_log.residuals.shape == (s.m_settings.admm_iters, 10)
