"""Augmented-Lagrangian PCG contact solver (extension, ls=4).

The vectorized hard-contact global step. The reference offers two
contact-capable solvers (SURVEY 2.12-2.13): NCMCGS — sequential-by-color
SOR with per-node projection (src/NodalMultiColorGS.hpp:94-142), ~240
dependent sub-steps per solve, latency-bound on an accelerator — and UzawaCG — CG on
the contact Schur complement needing one full A^-1 apply per CG iteration
(src/UzawaCG.hpp:92-120), ~11 inner solves per global step once A^-1 is
itself iterative.

This mode restructures the same saddle-point problem

    [ A  C^T ] [x]   [b]
    [ C  0   ] [y] = [c]

as one augmented-Lagrangian pass per ADMM iteration:

    (A + C^T C) x = b + C^T c - C^T y      (ONE matrix-free PCG solve)
    y <- y + (C x - c)                      (multiplier ascent)

with the ADMM loop itself as the outer AL iteration — constraints are
re-detected every ADMM iteration anyway (src/Solver.cpp:92-93), so the
multiplier converges across the iterations the solver already performs.
C rows carry the ck scaling (collision/constraints.py), so the penalty
weight is ck^2 and the scaled ascent step is 1 — the same fold the
reference itself uses for self-collision penalties inside NCMCGS
(A + C^T C, b + C^T c, src/NodalMultiColorGS.hpp:69-86); the multiplier
term is what upgrades that penalty to asymptotically-hard contact.

Cost: one PCG solve (~tens of fused SpMVs) per global step — roughly the
unconstrained ls=3 cost — versus Uzawa's 1 + schur_iters inner solves.
Everything is batched gathers/FMAs; no color sequencing, no nesting.

Warm starts carried in SimState: x from the previous ADMM iterate, y with
the active-SET equality gate (see system.SimState docstring).
"""

from __future__ import annotations

import jax.numpy as jnp

from admm_elastic_tpu.collision import constraints as con
from admm_elastic_tpu.solvers import pcg as pcg_mod


def _penalty_precond(pcg_data, A_hat, pen_diag):
    """The base A preconditioner with the penalty diagonal folded into
    the Jacobi / smoothing diagonal (shared by solve and solve_traced so
    logged steps advance the same state as fused steps)."""
    inv_d = 1.0 / (pcg_data.diag()[:, None] + pen_diag)
    if pcg_data.agg is None:
        return lambda r: inv_d * r

    import jax

    from admm_elastic_tpu.ops.reduction import dt_gather

    omega = 0.7

    def precond(r):
        z = omega * inv_d * r
        res = r - A_hat(z)
        rc = dt_gather(res, pcg_data.agg_gather)
        ec = jnp.matmul(pcg_data.coarse_inv, rc,
                        precision=jax.lax.Precision.HIGHEST)
        z = z + ec[pcg_data.agg]
        z = z + omega * inv_d * (r - A_hat(z))
        return z

    return precond


def solve(pcg_data: "pcg_mod.PCGData", hits: con.Hits, ck, b, x0, y,
          tol, max_iters):
    """One AL pass. Returns (x, y, pcg_iters).

    pcg_data: the ELL operator of A (jacobi or twogrid preconditioner).
    hits: deduped fixed-capacity constraint buffers.
    y: [2H] scaled multipliers (passive rows then dynamic rows).
    """
    n = b.shape[0]
    dtype = b.dtype
    h = hits.capacity
    active = jnp.concatenate([hits.p_mask, hits.d_mask])

    def Ct(yv):
        return con.Ct_apply(hits, ck, yv[:h], yv[h:], n)

    cp, cd = con.C_rhs(hits, ck)
    c = jnp.concatenate([cp, cd])

    def A_hat(x):
        return pcg_data.apply(x) + con.CtC_apply(hits, ck, x)

    b_hat = b + Ct(c - y)

    # Preconditioner: the base A preconditioner (Jacobi or two-grid)
    # cannot see the penalty rows, whose diagonal is ck^2-dominant where
    # contacts are active. Fold the penalty diagonal into the smoothing /
    # Jacobi diagonal; the two-grid coarse correction still targets the
    # smooth elastic modes, which the (local, well-conditioned-after-
    # rescale) penalty barely perturbs.
    pen_diag = con.CtC_diag(hits, ck, n, dtype)  # [N, 3]

    if hits.dense and not hits.may_dyn and pcg_data.agg is None:
        # Lane-major [3, N] CG internals (pcg.solve_T): the dense-surface
        # penalty is elementwise, so C^T C x = pn * (pn . x) with the
        # masked ck-scaled normals transposed ONCE per solve.
        pnT = (jnp.where(hits.p_mask, ck, 0.0)[None, :]
               * hits.p_normal.T)  # [3, N]

        def A_hat_T(xT):
            cx = jnp.sum(pnT * xT, axis=0)  # [N] = masked ck n.x
            return pcg_data.apply_T(xT) + pnT * cx[None, :]

        inv_dT = 1.0 / (pcg_data.diag()[None, :] + pen_diag.T)
        x, iters = pcg_mod.solve_T(A_hat_T, lambda r: inv_dT * r,
                                   b_hat, x0, tol, max_iters)
    else:
        precond = _penalty_precond(pcg_data, A_hat, pen_diag)
        x, iters = pcg_mod.solve(A_hat, precond, b_hat, x0, tol, max_iters)

    # Scaled multiplier ascent on the active rows.
    rp, rd = con.C_apply(hits, ck, x)
    r = jnp.concatenate([rp, rd]) - c
    y = jnp.where(active, y + r, 0.0)
    return x, y, iters


def solve_traced(pcg_data, hits: con.Hits, ck, b, x0, y, n_iters: int,
                 x_star=None, err_denom=None):
    """Fixed-length traced variant (SolverLog tier): the AL pass is one
    PCG solve on (A + C^T C), so the trace is pcg.solve_traced on that
    operator. Returns (x, y, {"res", "err"})."""
    n = b.shape[0]
    dtype = b.dtype
    h = hits.capacity
    active = jnp.concatenate([hits.p_mask, hits.d_mask])

    def Ct(yv):
        return con.Ct_apply(hits, ck, yv[:h], yv[h:], n)

    cp, cd = con.C_rhs(hits, ck)
    c = jnp.concatenate([cp, cd])

    def A_hat(x):
        return pcg_data.apply(x) + con.CtC_apply(hits, ck, x)

    b_hat = b + Ct(c - y)
    precond = _penalty_precond(
        pcg_data, A_hat, con.CtC_diag(hits, ck, n, dtype))
    x, tr = pcg_mod.solve_traced(A_hat, precond, b_hat, x0,
                                 n_iters, x_star=x_star, err_denom=err_denom)
    rp, rd = con.C_apply(hits, ck, x)
    r = jnp.concatenate([rp, rd]) - c
    y = jnp.where(active, y + r, 0.0)
    return x, y, tr
