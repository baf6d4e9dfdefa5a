"""Safeguarded Anderson acceleration of the ADMM fixed point.

The ADMM iteration of this solver (local prox + global solve,
src/Solver.cpp:80-102 in the reference) is Douglas-Rachford splitting on
the element-space variable v = D x + u: one iteration maps

    z = prox(v);  u = v - z;  x = A^-1 b(z, u);  v' = D x + u = g(v).

Anderson acceleration (type II, window m) extrapolates v from the last m
fixed-point residuals f_i = g(v_i) - v_i, falling back to the plain
iterate whenever the residual norm does not decrease (the safeguard of
Peng, Deng, Zhang, Liu "Anderson Acceleration for Geometry Optimization
and Physics Simulation", 2018 — applied there to exactly this family of
local-global solvers). All state is fixed-shape rolling buffers, so the
whole thing lives inside the jitted ADMM loop; cost per iteration is a
few [m, L] dot products + an m x m solve (m <= ~6), negligible next to
the global solve.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

_HIGHEST = jax.lax.Precision.HIGHEST


@dataclasses.dataclass(frozen=True)
class AAState:
    """Rolling Anderson history (all fixed shapes; L = len(v))."""

    dv: jax.Array  # [m, L] differences v_{i+1} - v_i
    dg: jax.Array  # [m, L] differences g_{i+1} - g_i
    v_prev: jax.Array  # [L] previous v
    g_prev: jax.Array  # [L] previous g(v)
    count: jax.Array  # i32 valid history entries (<= m)
    prev_fnorm: jax.Array  # ||f|| of the last accepted iterate


jax.tree_util.register_dataclass(
    AAState,
    data_fields=("dv", "dg", "v_prev", "g_prev", "count", "prev_fnorm"),
    meta_fields=(),
)


def init(m: int, v0: jax.Array) -> AAState:
    big = jnp.asarray(jnp.finfo(v0.dtype).max, v0.dtype)
    return AAState(
        dv=jnp.zeros((m,) + v0.shape, v0.dtype),
        dg=jnp.zeros((m,) + v0.shape, v0.dtype),
        v_prev=v0,
        g_prev=jnp.zeros_like(v0),
        count=jnp.asarray(0, jnp.int32),
        prev_fnorm=big,
    )


def update(state: AAState, v: jax.Array, gv: jax.Array,
           safeguard: float = 1.0, reg: float = 1e-10):
    """One safeguarded AA step.

    Args:
      state: rolling history.
      v: current iterate (the one gv was computed from).
      gv: g(v), the plain next iterate.
      safeguard: accept acceleration only while ||f|| <= safeguard *
        previous accepted ||f||; on violation the history is cleared and
        the plain iterate is taken (monotone residual enforcement).
      reg: Tikhonov regularization of the m x m normal equations.

    Returns (v_next, new_state).
    """
    m = state.dv.shape[0]
    f = gv - v
    fnorm = jnp.sqrt(jnp.sum(f * f))

    ok = fnorm <= safeguard * state.prev_fnorm
    # On reset: drop the history AND the pending (v_prev, g_prev) pair.
    count = jnp.where(ok, state.count, 0)

    have_prev = count > 0
    new_dv = v - state.v_prev
    new_dg = gv - state.g_prev
    slot = jnp.mod(jnp.maximum(count - 1, 0), m)
    dv = jnp.where(
        have_prev,
        jax.lax.dynamic_update_index_in_dim(state.dv, new_dv, slot, 0),
        jnp.zeros_like(state.dv),
    )
    dg = jnp.where(
        have_prev,
        jax.lax.dynamic_update_index_in_dim(state.dg, new_dg, slot, 0),
        jnp.zeros_like(state.dg),
    )

    n_hist = jnp.minimum(count, m)
    valid = (jnp.arange(m) < n_hist)[:, None]
    df = (dg - dv) * valid  # [m, L]

    # Normal equations (df df^T + lam I) theta = df f, masked slots get an
    # identity row (theta = 0 there).
    gram = jnp.matmul(df, df.T, precision=_HIGHEST)
    rhs = jnp.matmul(df, f, precision=_HIGHEST)
    scale = jnp.maximum(jnp.trace(gram), 1.0)
    eye = jnp.eye(m, dtype=v.dtype)
    mask_d = jnp.where(valid[:, 0], 0.0, 1.0)
    gram = gram + (reg * scale) * eye + jnp.diag(mask_d)
    theta = jnp.linalg.solve(gram, rhs)

    v_acc = gv - jnp.matmul(theta, dg * valid, precision=_HIGHEST)
    use_acc = have_prev & ok
    v_next = jnp.where(use_acc, v_acc, gv)

    new_state = AAState(
        dv=dv,
        dg=dg,
        v_prev=v,
        g_prev=gv,
        count=count + 1,
        prev_fnorm=jnp.where(ok, fnorm, state.prev_fnorm * jnp.asarray(1.0, v.dtype)),
    )
    return v_next, new_state, fnorm
