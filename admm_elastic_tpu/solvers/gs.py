"""Nodal-constrained multicolor Gauss-Seidel (reference NodalMultiColorGS).

Vectorized re-design of src/NodalMultiColorGS.hpp: the reference walks color
classes with an OpenMP loop per color, updating one 3-dof node at a time
with SOR (omega=1.9), overriding pinned nodes, re-detecting passive
collisions *per node inside the sweep* and projecting constrained updates
onto the contact tangent plane (Eq. 47 of the TVCG paper). Self-collisions
are folded in as a penalty A + C^T C, b + C^T c (src/NodalMultiColorGS.hpp:69-86).

Here each color class updates as one batched kernel:
- the off-diagonal row sums come from a padded ELL matrix (gather + fused
  multiply-add, no sparse iterators),
- colors are precomputed host-side (static topology; greedy coloring in
  system/assembly.py replaces mcl::graphcolor::color_matrix),
- the C^T C penalty is applied matrix-free from the masked hit buffers
  (fresh per color so later colors see earlier updates, like true GS),
- passive contacts are re-detected for the whole color at once and the
  constrained update is a masked tangent-plane projection.

POSITIONING (do not spend perf effort here): ls=1 is the *parity oracle*,
not a performance mode. Its ~240 dependent color sub-steps per solve are
latency-bound by construction — no kernel can batch across colors without
changing the iteration — so it will only ever tie a CPU core (measured
1.04-1.13x ref). It is kept because it reproduces the reference's
NodalMultiColorGS trajectories to 1.3e-12 (tests/test_parity.py), which is
what anchors every other solver's correctness. For throughput use ls=4
(AL-PCG) for contact and ls=3 (ELL-PCG) otherwise — see BASELINE.md's
guidance table.

Deviation from the reference: when self-collision penalties are active the
reference re-colors A + C^T C on the fly (src/NodalMultiColorGS.hpp:83-85);
re-coloring is not jit-stable, so hit-coupled nodes in the same color update
Jacobi-style within that sweep. Contacts are transient and the sweep count
dominates convergence, so this matches the reference's results in practice
(validated by the contact tests).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from admm_elastic_tpu.collision import constraints as con
from admm_elastic_tpu.collision.passive import detect_passive


def _ortho_tangent(n):
    """Orthonormal tangent basis (u, v) of the contact plane.

    Mirrors NodalMultiColorGS::orthoG (src/NodalMultiColorGS.hpp:152-160).
    """
    cond = (n[..., 0] > 0.999)[..., None]
    # Constant broadcasts, NOT zeros().at[..., k].set(1.0): see
    # collision/passive.py Floor.signed_distance.
    ez = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0], n.dtype), n.shape)
    ex = jnp.broadcast_to(jnp.asarray([1.0, 0.0, 0.0], n.dtype), n.shape)
    not_n = jnp.where(cond, ez, ex)
    u = jnp.cross(not_n, n)
    u = u / jnp.maximum(jnp.linalg.norm(u, axis=-1, keepdims=True), 1e-30)
    v = jnp.cross(n, u)
    v = v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-30)
    return u, v


def ell_offdiag_mv(ell_cols, ell_vals, x):
    """Off-diagonal part of A x via padded ELL: [N,3]."""
    return jnp.sum(ell_vals[..., None] * x[ell_cols], axis=1)


def _sweep_setup(
    ell_cols, ell_vals, diag, colors, colors_mask, b, pin_mask, pin_target,
    obstacles, hits: con.Hits, ck, omega, may_have_dyn: bool = True,
):
    """Shared setup for the SOR sweeps: returns (color_update, residual2,
    b_eff) closures used by both the early-exit solve and the fixed-length
    traced variant.

    may_have_dyn=False (TRACE-time knowledge: no dynamic colliders are
    registered, so hits.d_mask is identically False) removes the whole
    self-collision penalty pipeline — ~6 masked gather/scatter passes over
    the full vertex set per color per sweep that XLA cannot eliminate from
    the traced masks alone."""
    n = diag.shape[0]
    dtype = b.dtype

    if may_have_dyn:
        has_dyn = hits.n_active() > 0
        pen_diag = jnp.where(has_dyn, con.CtC_diag(hits, ck, n, dtype),
                             jnp.zeros((n, 3), dtype))
        b_eff = b + con.Ct_c(hits, ck, n)
    else:
        pen_diag = None
        b_eff = b

    def color_update(ci, x):
        rows = colors[ci]  # [L], padded with n
        m = colors_mask[ci]  # [L]
        safe_rows = jnp.minimum(rows, n - 1)
        lux = ell_offdiag_mv(ell_cols[safe_rows], ell_vals[safe_rows], x)  # [L,3]
        if may_have_dyn:
            aii = diag[safe_rows][:, None] + pen_diag[safe_rows]
            # Penalty off-diagonal contribution (fresh x -> true GS across
            # colors).
            ctc_x = con.CtC_apply(hits, ck, x)
            lux = lux + ctc_x[safe_rows] - pen_diag[safe_rows] * x[safe_rows]
        else:
            aii = diag[safe_rows][:, None]

        bi = b_eff[safe_rows]
        x_gs = (bi - lux) / aii
        x_old = x[safe_rows]
        x_new = (1.0 - omega) * x_old + omega * x_gs

        if obstacles:
            # Per-node passive re-detection at the updated position
            # (src/NodalMultiColorGS.hpp:121-126), then the constrained
            # tangent-plane update (no over-relaxation,
            # src/NodalMultiColorGS.hpp:218-262).
            dx, p, nrm, hit, _ = detect_passive(obstacles, x_new)
            delta = x_gs - p
            u, v = _ortho_tangent(nrm)
            x_con = (
                u * jnp.sum(u * delta, axis=-1, keepdims=True)
                + v * jnp.sum(v * delta, axis=-1, keepdims=True)
                + p
            )
            x_new = jnp.where(hit[..., None], x_con, x_new)

        # Pins have highest priority (src/NodalMultiColorGS.hpp:110-117).
        pinned = pin_mask[safe_rows]
        x_new = jnp.where(pinned[..., None], pin_target[safe_rows], x_new)

        x = x.at[rows].set(jnp.where(m[:, None], x_new, x[safe_rows]), mode="drop")
        return x

    def residual2(x):
        ax = diag[:, None] * x + ell_offdiag_mv(ell_cols, ell_vals, x)
        if may_have_dyn:
            ax = ax + con.CtC_apply(hits, ck, x)
        r = b_eff - ax
        return jnp.sum(r * r)

    return color_update, residual2, b_eff


def solve(
    ell_cols,
    ell_vals,
    diag,
    colors,
    colors_mask,
    b,
    x0,
    pin_mask,
    pin_target,
    obstacles,
    hits: con.Hits,
    ck,
    omega,
    max_iters,
    tol,
    may_have_dyn: bool = True,
):
    """Run constrained multicolor SOR sweeps. Returns (x, iters).

    colors: i32 [C, L] vertex ids per color, padded with N (dropped).
    hits: dynamic-only constraint buffers (p_mask must be all-False here;
    passive contacts are handled by the per-node projection instead).
    may_have_dyn=False: statically no dynamic colliders (see _sweep_setup).
    """
    dtype = b.dtype
    n_colors = colors.shape[0]
    color_update, residual2, b_eff = _sweep_setup(
        ell_cols, ell_vals, diag, colors, colors_mask, b, pin_mask,
        pin_target, obstacles, hits, ck, omega, may_have_dyn=may_have_dyn,
    )
    b_norm2 = jnp.sum(b_eff * b_eff)
    # Clamp to the dtype's achievable relative residual: the reference
    # default tol=1e-10 is below f32 machine precision, which would
    # force max_iters every solve (in f64 the clamp is a no-op).
    tol = jnp.maximum(tol, 64 * jnp.finfo(dtype).eps)
    tol2 = tol * tol * jnp.maximum(b_norm2, jnp.finfo(dtype).tiny)

    def cond(carry):
        _, k, done = carry
        return (~done) & (k < max_iters)

    def body(carry):
        x, k, _ = carry
        x = jax.lax.fori_loop(0, n_colors, color_update, x)
        done = residual2(x) < tol2
        return (x, k + 1, done)

    x, iters, _ = jax.lax.while_loop(cond, body, (x0, jnp.asarray(0, jnp.int32), jnp.asarray(False)))
    return x, iters


def solve_traced(
    ell_cols, ell_vals, diag, colors, colors_mask, b, x0, pin_mask,
    pin_target, obstacles, hits: con.Hits, ck, omega, n_sweeps: int,
    x_star=None, err_denom=None, may_have_dyn: bool = True,
):
    """Fixed-length SOR sweeps with a per-sweep residual trace.

    SolverLog-tier instrumentation (the reference records error/runtime
    per inner iteration inside NodalMultiColorGS::solve,
    src/NodalMultiColorGS.hpp:61,135,144): runs exactly n_sweeps as a
    lax.scan and emits res [n_sweeps] = ||b_eff - (A + C^T C) x_k|| plus
    err vs x_star when given. Returns (x, {"res", "err"}).
    """
    n_colors = colors.shape[0]
    color_update, residual2, _ = _sweep_setup(
        ell_cols, ell_vals, diag, colors, colors_mask, b, pin_mask,
        pin_target, obstacles, hits, ck, omega, may_have_dyn=may_have_dyn,
    )
    if x_star is not None and err_denom is None:
        err_denom = jnp.maximum(jnp.linalg.norm(x_star - x0),
                                jnp.finfo(b.dtype).tiny)

    def body(x, _):
        x = jax.lax.fori_loop(0, n_colors, color_update, x)
        res = jnp.sqrt(residual2(x))
        err = (jnp.linalg.norm(x_star - x) / err_denom
               if x_star is not None else jnp.asarray(0.0, b.dtype))
        return x, (res, err)

    x, (res, err) = jax.lax.scan(body, x0, None, length=n_sweeps)
    return x, {"res": res, "err": (err if x_star is not None else None)}
