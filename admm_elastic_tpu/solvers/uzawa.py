"""Uzawa saddle-point solver: CG on the contact Schur complement.

Vectorized re-design of the reference UzawaCG (src/UzawaCG.hpp:32-125):

    [ A  C^T ] [x]   [b]
    [ C  0   ] [y] = [c]

CG runs on  S = C A^-1 C^T  without forming it — each iteration is
C^T apply (masked scatter), one prefactored A^-1 apply (two batched
triangular solves), and C apply (masked gather). Constraint rows live in
fixed-capacity masked buffers (collision/constraints.py) so the iteration
count and shapes are static under jit; inactive rows have zero C rows and
therefore never influence the Krylov space.

Multiplier warm-starting across solves matches the reference: y is kept
when the active-constraint count is unchanged, reset otherwise
(src/UzawaCG.hpp:68-74).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from admm_elastic_tpu.collision import constraints as con


def _dot(a, b):
    return jnp.dot(a, b, precision=jax.lax.Precision.HIGHEST)

# Inner warm start across Schur iterations: measured and rejected on the
# previous accelerator. The CG recurrence gives
# a free guess for the iterative inner (A^-1 C^T d_k = A^-1 C^T r_k -
# beta_{k-1} q2_{k-1}), but on the beam-floor-uzawa-67k matrix scene it
# bought 0.99x (the tol-terminated inner saves no iterations: successive
# Schur directions are conjugate, so the known term is not dominant),
# and a large beta can hand the inner a guess WORSE than zero, blowing
# its iteration budget (test_uzawa_sparse_inner_matches_dense launched
# the resting body upward). The toggle below exists only so the lab can
# re-measure; production keeps the cold start.
INNER_WARM_START = False


def solve(apply_Ainv, hits: con.Hits, ck, b0, x_guess, y, max_iters, tol):
    """Returns (x, y, iters).

    apply_Ainv: (rhs [N,3], x0 [N,3] | None) -> [N,3] A^-1 apply — exact
      (prefactored dense) or an inner PCG solve (sparse path); x0 is a
      warm start that iterative inners may use and exact inners ignore.
    hits: deduped fixed-capacity constraint buffers.
    y: [2H] warm-start multipliers (passive rows then dynamic rows).
    """
    n = b0.shape[0]
    dtype = b0.dtype
    h = hits.capacity

    def C(x):
        rp, rd = con.C_apply(hits, ck, x)
        return jnp.concatenate([rp, rd])

    def Ct(yv):
        return con.Ct_apply(hits, ck, yv[:h], yv[h:], n)

    cp, cd = con.C_rhs(hits, ck)
    c = jnp.concatenate([cp, cd])

    # NOTE: no lax.cond fast path for the zero-constraint case. One
    # accelerator compiler (not the GPU's) miscompiled cond(pred, <branch
    # with while_loop>, ...) fused with the upstream detection program —
    # the TRUE branch was skipped with a verifiably true predicate. The
    # constrained
    # path degenerates correctly anyway when nothing is active: all C
    # rows are masked to zero, so r0 = 0 and the CG while_loop exits
    # after one iteration with x = A^-1 b, matching the reference's fast
    # path (src/UzawaCG.hpp:76-81) at the cost of one masked gather.
    def constrained(_):
        # The previous ADMM iterate is an excellent warm start for the
        # first solve (b changes O(dt) per iteration); the Schur-direction
        # solves below have no useful guess and start from zero.
        x0 = apply_Ainv(b0 - Ct(y), x_guess)
        r0 = C(x0) - c
        # Mask inactive rows out of the residual (their C row is 0 but c
        # could be stale-free anyway; keep it clean).
        active = jnp.concatenate([hits.p_mask, hits.d_mask])
        r0 = jnp.where(active, r0, 0.0)
        d0 = r0
        tiny = jnp.finfo(dtype).tiny
        # Clamp to the dtype's achievable relative residual: the reference
        # default tol=1e-10 is below f32 machine precision, which would
        # force max_iters every solve (in f64 the clamp is a no-op).
        tol_c = jnp.maximum(jnp.asarray(tol, dtype), 64 * jnp.finfo(dtype).eps)
        tol2 = tol_c * tol_c

        def cond(carry):
            _, _, r, d, _, _, k, done = carry
            return (~done) & (k < max_iters)

        def body(carry):
            x, yv, r, d, q2p, betap, k, _ = carry
            # Iterative-inner warm start across Schur iterations: see the
            # module-level note — measured at 0.99x and destabilizing, so
            # OFF in production; the carry plumbing stays for the lab.
            q2 = apply_Ainv(
                Ct(d), (-betap * q2p) if INNER_WARM_START else None)
            q3 = jnp.where(active, C(q2), 0.0)
            denom = _dot(d, q3)
            bad = jnp.abs(denom) < tiny
            alpha = jnp.where(bad, 0.0, _dot(d, r) / jnp.where(bad, 1.0, denom))
            x = x - alpha * q2
            yv = yv + alpha * d
            r = r - alpha * q3
            small = _dot(r, r) < tol2
            beta = jnp.where(bad, 0.0, _dot(r, q3) / jnp.where(bad, 1.0, denom))
            d = r - beta * d
            done = bad | small
            return (x, yv, r, d, q2, beta, k + 1, done)

        zero3 = jnp.zeros((n, 3), dtype)
        init = (x0, y, r0, d0, zero3, jnp.asarray(0.0, dtype),
                jnp.asarray(0, jnp.int32), jnp.asarray(False))
        x, yv, _, _, _, _, iters, _ = jax.lax.while_loop(cond, body, init)
        return x, yv, jnp.maximum(iters, 1)

    return constrained(None)


def solve_traced(apply_Ainv, hits: con.Hits, ck, b0, x_guess, y, n_iters: int,
                 x_star=None, err_denom=None):
    """Fixed-length Schur CG with a per-iteration residual trace.

    SolverLog-tier instrumentation (the reference hooks SolverLog into
    UzawaCG::solve per CG iteration, src/UzawaCG.hpp:59,112,122): runs
    exactly n_iters as a lax.scan, emitting res [n_iters] = ||C x_k - c||
    (the Schur residual the solve drives to zero) and err vs x_star when
    given. Returns (x, y, {"res", "err"}).
    """
    n = b0.shape[0]
    dtype = b0.dtype
    h = hits.capacity
    tiny = jnp.finfo(dtype).tiny

    def C(x):
        rp, rd = con.C_apply(hits, ck, x)
        return jnp.concatenate([rp, rd])

    def Ct(yv):
        return con.Ct_apply(hits, ck, yv[:h], yv[h:], n)

    cp, cd = con.C_rhs(hits, ck)
    c = jnp.concatenate([cp, cd])
    active = jnp.concatenate([hits.p_mask, hits.d_mask])

    if x_star is not None and err_denom is None:
        err_denom = jnp.maximum(jnp.linalg.norm(x_star - x_guess), tiny)

    x0 = apply_Ainv(b0 - Ct(y), x_guess)
    r0 = jnp.where(active, C(x0) - c, 0.0)

    def body(carry, _):
        x, yv, r, d = carry
        q2 = apply_Ainv(Ct(d))
        q3 = jnp.where(active, C(q2), 0.0)
        denom = _dot(d, q3)
        bad = jnp.abs(denom) < tiny
        alpha = jnp.where(bad, 0.0, _dot(d, r) / jnp.where(bad, 1.0, denom))
        x = x - alpha * q2
        yv = yv + alpha * d
        r = r - alpha * q3
        beta = jnp.where(bad, 0.0, _dot(r, q3) / jnp.where(bad, 1.0, denom))
        d = r - beta * d
        res = jnp.sqrt(_dot(r, r))
        err = (jnp.linalg.norm(x_star - x) / err_denom
               if x_star is not None else jnp.asarray(0.0, dtype))
        return (x, yv, r, d), (res, err)

    (x, yv, _, _), (res, err) = jax.lax.scan(
        body, (x0, y, r0, r0), None, length=n_iters
    )
    return x, yv, {"res": res, "err": (err if x_star is not None else None)}
