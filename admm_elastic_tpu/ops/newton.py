"""Batched fixed-iteration projected Newton in principal-stretch space.

Replaces the reference's per-element ``mcl::optlib::LBFGS<double,3>`` with
line search (src/TetEnergyTerm.cpp:133, src/TetEnergyTerm.hpp:90-97): a
branchy, data-dependent scalar optimizer that cannot batch. Here every
element solves the same 3-variable problem

    min_{s > 0}  psi(s) + (k/2) ||s - s0||^2

with analytic gradient and Hessian, via a fixed number of damped Newton
iterations with a masked backtracking line search. All control flow is
static, so millions of elements run in lockstep.

The barrier semantics of the reference are preserved: candidate points with
any s_i <= 0 evaluate to +inf (the reference returns FLT_MAX from value(),
src/TetEnergyTerm.cpp:184-192), so backtracking never accepts them.
Convergence masking uses the reference tolerances (|g| < 1e-6 or
|dx| < 1e-6, src/TetEnergyTerm.hpp:92-95).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _solve3x3_sym(H, g):
    """Solve H d = g for symmetric 3x3 H (batched) via adjugate/Cramer."""
    a, b, c = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    d, e, f = H[..., 1, 1], H[..., 1, 2], H[..., 2, 2]
    # Cofactors.
    A = d * f - e * e
    B = c * e - b * f
    C = b * e - c * d
    D = a * f - c * c
    E = b * c - a * e
    F = a * d - b * b
    det = a * A + b * B + c * C
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-300, 1.0, det)
    g0, g1, g2 = g[..., 0], g[..., 1], g[..., 2]
    d0 = (A * g0 + B * g1 + C * g2) * inv_det
    d1 = (B * g0 + D * g1 + E * g2) * inv_det
    d2 = (C * g0 + E * g1 + F * g2) * inv_det
    return jnp.stack([d0, d1, d2], axis=-1), det


def newton_prox(value_fn, grad_fn, hess_fn, s_init, n_iters: int = 8, n_backtrack: int = 8,
                tol: float = 1e-6, floor: float = 1e-9):
    """Minimize a batch of smooth 3-var objectives with s > 0 barrier.

    Args:
      value_fn: (s [B,3]) -> [B] objective (must return +inf for s<=0).
      grad_fn:  (s [B,3]) -> [B,3].
      hess_fn:  (s [B,3]) -> [B,3,3] symmetric.
      s_init:   [B,3] starting point (must be feasible, s>0).
      n_iters:  fixed Newton iteration count (static).
      n_backtrack: fixed halving count for the masked line search (static).
    Returns: s [B,3] approximate minimizer.
    """

    # dtype-matched identity: a bare jnp.eye(3) is f64 under x64 and
    # silently promotes the whole Newton carry (breaking f32 runs in the
    # x64-enabled test env).
    eye3 = jnp.eye(3, dtype=jnp.asarray(s_init).dtype)

    def body(s, _):
        g = grad_fn(s)
        H = hess_fn(s)
        # Active-set reduction: coordinates pinned at the s>0 barrier with
        # an inward-pushing gradient are frozen out of the Newton system,
        # so the pinned coordinate doesn't poison the direction of the
        # free ones (projected Newton).
        pinned = (s <= floor * 10.0) & (g > 0.0)
        free = (~pinned).astype(s.dtype)
        g = g * free
        H = H * free[..., :, None] * free[..., None, :] + pinned[..., None] * eye3
        # Levenberg damping if the Hessian is not safely PD: add tau*I with
        # tau based on the most negative Gershgorin bound estimate.
        diag = jnp.stack([H[..., 0, 0], H[..., 1, 1], H[..., 2, 2]], axis=-1)
        offsum = jnp.sum(jnp.abs(H), axis=-1) - jnp.abs(diag)
        min_gersh = jnp.min(diag - offsum, axis=-1)
        tau = jnp.maximum(0.0, 1e-6 - min_gersh)
        Hd = H + tau[..., None, None] * jnp.eye(3, dtype=s.dtype)
        d, det = _solve3x3_sym(Hd, g)
        # Fall back to gradient direction when the (damped) Hessian solve is
        # degenerate.
        bad = jnp.abs(det) < 1e-300
        d = jnp.where(bad[..., None], g, d)

        # Masked backtracking line search on the true objective.
        f0 = value_fn(s)
        best_s = s
        best_f = f0
        t = jnp.ones(s.shape[:-1], dtype=s.dtype)
        accepted = jnp.zeros(s.shape[:-1], dtype=bool)
        for _ in range(n_backtrack):
            # Projected step: clamp to the feasible region so a component
            # pinned at the barrier doesn't block progress in the others
            # (boundary minimizers occur for StVK-type psi with inverted
            # anchors, where the unconstrained minimizer has s_i < 0).
            cand = jnp.maximum(s - t[..., None] * d, floor)
            fc = value_fn(cand)
            take = (~accepted) & (fc < best_f)
            best_s = jnp.where(take[..., None], cand, best_s)
            best_f = jnp.where(take, fc, best_f)
            accepted = accepted | take
            t = t * 0.5

        # Convergence mask (reference: src/TetEnergyTerm.hpp:92-95): once an
        # element is converged its iterate is frozen.
        gnorm = jnp.linalg.norm(g, axis=-1)
        step = jnp.linalg.norm(best_s - s, axis=-1)
        converged = (gnorm < tol) | (step < tol)
        s_new = jnp.where(converged[..., None], s, best_s)
        return s_new, None

    s, _ = jax.lax.scan(body, s_init, None, length=n_iters)
    return s
