"""SoA hyperelastic prox: signed SVD + projected Newton on scalar triples.

The SoA counterpart of ops/prox.prox_tet_hyper / ops/newton.newton_prox —
all quantities are [T]-shaped arrays (one array per matrix entry). Semantics
identical: quad-penalty anchor is the *signed* stretch, eps-inflation of
collapsed elements, sign rectification, s>0 barrier with projected steps
and an active-set reduction (reference: src/TetEnergyTerm.cpp:114-136 with
the L-BFGS inner solve replaced by fixed-iteration Newton).
"""

from __future__ import annotations

import jax.numpy as jnp

from admm_elastic_tpu.materials import spline_d2fgh, spline_dfgh, spline_fgh
from admm_elastic_tpu.ops import soa
from admm_elastic_tpu.ops.prox import (
    TET_NEOHOOKEAN,
    TET_STVK,
    _SPLINE_KIND,
)


def _vgh_soa(model: str, mu, lam, kappa, k, s0):
    """(value, grad, hess) closures on vec3-tuples; hess returns the compact
    symmetric 6-tuple (h11, h22, h33, h12, h13, h23)."""
    big = jnp.asarray(jnp.finfo(s0[0].dtype).max, s0[0].dtype)

    if model == TET_NEOHOOKEAN:
        def psi(s):
            J = s[0] * s[1] * s[2]
            I1 = s[0] * s[0] + s[1] * s[1] + s[2] * s[2]
            logI3 = jnp.log(J * J)
            return 0.5 * mu * (I1 - logI3 - 3.0) + 0.125 * lam * logI3 * logI3

        def grad_psi(s):
            J = s[0] * s[1] * s[2]
            lj = lam * jnp.log(J)
            return tuple(mu * (si - 1.0 / si) + lj / si for si in s)

        def hess_psi(s):
            J = s[0] * s[1] * s[2]
            logJ = jnp.log(J)
            inv = tuple(1.0 / si for si in s)
            h_d = tuple(mu * (1.0 + iv * iv) + lam * (1.0 - logJ) * iv * iv for iv in inv)
            return (
                h_d[0], h_d[1], h_d[2],
                lam * inv[0] * inv[1], lam * inv[0] * inv[2], lam * inv[1] * inv[2],
            )

    elif model == TET_STVK:
        def psi(s):
            st = tuple(0.5 * (si * si - 1.0) for si in s)
            tr = st[0] + st[1] + st[2]
            return mu * (st[0] ** 2 + st[1] ** 2 + st[2] ** 2) + 0.5 * lam * tr * tr

        def grad_psi(s):
            sum_s2 = s[0] * s[0] + s[1] * s[1] + s[2] * s[2]
            half = 0.5 * lam * (sum_s2 - 3.0)
            return tuple(mu * si * (si * si - 1.0) + half * si for si in s)

        def hess_psi(s):
            sum_s2 = s[0] * s[0] + s[1] * s[1] + s[2] * s[2]
            half = 0.5 * lam * (sum_s2 - 3.0)
            h_d = tuple(mu * (3.0 * si * si - 1.0) + half + lam * si * si for si in s)
            return (
                h_d[0], h_d[1], h_d[2],
                lam * s[0] * s[1], lam * s[0] * s[2], lam * s[1] * s[2],
            )

    elif model in _SPLINE_KIND:
        kind = _SPLINE_KIND[model]

        def psi(s):
            s1, s2, s3 = s
            J = jnp.maximum(s1 * s2 * s3, 1e-30)
            total = None
            for xi in (s1, s2, s3):
                fv, _, _ = spline_fgh(kind, xi, xi, J, mu, lam, kappa)
                total = fv if total is None else total + fv
            for pq in (s1 * s2, s2 * s3, s3 * s1):
                _, gv, _ = spline_fgh(kind, pq, pq, J, mu, lam, kappa)
                total = total + gv
            _, _, hv = spline_fgh(kind, J, J, J, mu, lam, kappa)
            return total + hv

        def grad_psi(s):
            s1, s2, s3 = s
            J = jnp.maximum(s1 * s2 * s3, 1e-30)
            df1, dg12, dh = spline_dfgh(kind, s1, s1 * s2, J, mu, lam, kappa)
            df2, dg23, _ = spline_dfgh(kind, s2, s2 * s3, J, mu, lam, kappa)
            df3, dg31, _ = spline_dfgh(kind, s3, s3 * s1, J, mu, lam, kappa)
            return (
                df1 + dg12 * s2 + dg31 * s3 + dh * s2 * s3,
                df2 + dg23 * s3 + dg12 * s1 + dh * s3 * s1,
                df3 + dg31 * s1 + dg23 * s2 + dh * s1 * s2,
            )

        def hess_psi(s):
            s1, s2, s3 = s
            J = jnp.maximum(s1 * s2 * s3, 1e-30)
            _, dg12, dh = spline_dfgh(kind, s1, s1 * s2, J, mu, lam, kappa)
            _, dg23, _ = spline_dfgh(kind, s2, s2 * s3, J, mu, lam, kappa)
            _, dg31, _ = spline_dfgh(kind, s3, s3 * s1, J, mu, lam, kappa)
            d2f1, d2g12, d2h = spline_d2fgh(kind, s1, s1 * s2, J, mu, lam, kappa)
            d2f2, d2g23, _ = spline_d2fgh(kind, s2, s2 * s3, J, mu, lam, kappa)
            d2f3, d2g31, _ = spline_d2fgh(kind, s3, s3 * s1, J, mu, lam, kappa)
            h11 = d2f1 + d2g12 * s2 * s2 + d2g31 * s3 * s3 + d2h * (s2 * s3) ** 2
            h22 = d2f2 + d2g23 * s3 * s3 + d2g12 * s1 * s1 + d2h * (s3 * s1) ** 2
            h33 = d2f3 + d2g31 * s1 * s1 + d2g23 * s2 * s2 + d2h * (s1 * s2) ** 2
            h12 = dg12 + d2g12 * s1 * s2 + d2h * (s2 * s3) * (s3 * s1) + dh * s3
            h13 = dg31 + d2g31 * s3 * s1 + d2h * (s2 * s3) * (s1 * s2) + dh * s2
            h23 = dg23 + d2g23 * s2 * s3 + d2h * (s3 * s1) * (s1 * s2) + dh * s1
            return (h11, h22, h33, h12, h13, h23)

    else:
        raise ValueError(f"unknown hyperelastic model {model!r}")

    def value(s):
        infeasible = (s[0] <= 0.0) | (s[1] <= 0.0) | (s[2] <= 0.0)
        quad = 0.5 * k * sum((si - s0i) ** 2 for si, s0i in zip(s, s0))
        clamped = tuple(jnp.maximum(si, 1e-30) for si in s)
        return jnp.where(infeasible, big, psi(clamped) + quad)

    def grad(s):
        g = grad_psi(s)
        return tuple(gi + k * (si - s0i) for gi, si, s0i in zip(g, s, s0))

    def hess(s):
        h = hess_psi(s)
        return (h[0] + k, h[1] + k, h[2] + k, h[3], h[4], h[5])

    return value, grad, hess


def newton_soa(value, grad, hess, s, n_iters: int, n_backtrack: int = 8,
               tol: float = 1e-6, floor: float = 1e-9, unroll: bool = True):
    """Projected active-set Newton on vec3-tuples (see ops/newton.py)."""

    def newton_iter(s):
        g = grad(s)
        h6 = hess(s)
        # Active set: coordinates pinned at the barrier with inward gradient.
        pinned = tuple((si <= floor * 10.0) & (gi > 0.0) for si, gi in zip(s, g))
        free = tuple(jnp.where(p, 0.0, 1.0) for p in pinned)
        g = tuple(gi * fi for gi, fi in zip(g, free))
        h11 = h6[0] * free[0] * free[0] + jnp.where(pinned[0], 1.0, 0.0)
        h22 = h6[1] * free[1] * free[1] + jnp.where(pinned[1], 1.0, 0.0)
        h33 = h6[2] * free[2] * free[2] + jnp.where(pinned[2], 1.0, 0.0)
        h12 = h6[3] * free[0] * free[1]
        h13 = h6[4] * free[0] * free[2]
        h23 = h6[5] * free[1] * free[2]

        # Levenberg damping from the Gershgorin bound.
        r1 = h11 - jnp.abs(h12) - jnp.abs(h13)
        r2 = h22 - jnp.abs(h12) - jnp.abs(h23)
        r3 = h33 - jnp.abs(h13) - jnp.abs(h23)
        tau = jnp.maximum(0.0, 1e-6 - jnp.minimum(jnp.minimum(r1, r2), r3))
        d, det = soa.solve3x3_sym_soa((h11 + tau, h22 + tau, h33 + tau, h12, h13, h23), g)
        bad = jnp.abs(det) < 1e-300
        d = tuple(jnp.where(bad, gi, di) for gi, di in zip(g, d))

        def backtrack(carry):
            best, best_f, accepted, t = carry
            cand = tuple(jnp.maximum(si - t * di, floor) for si, di in zip(s, d))
            fc = value(cand)
            take = (~accepted) & (fc < best_f)
            best = tuple(jnp.where(take, ci, bi) for ci, bi in zip(cand, best))
            best_f = jnp.where(take, fc, best_f)
            return best, best_f, accepted | take, t * 0.5

        f0 = value(s)
        best, _, _, _ = soa.repeat(
            backtrack, n_backtrack,
            (s, f0, jnp.zeros_like(f0, dtype=bool), jnp.ones_like(f0)), unroll)

        gnorm2 = g[0] ** 2 + g[1] ** 2 + g[2] ** 2
        step2 = sum((bi - si) ** 2 for bi, si in zip(best, s))
        converged = (gnorm2 < tol * tol) | (step2 < tol * tol)
        return tuple(jnp.where(converged, si, bi) for si, bi in zip(s, best))

    return soa.repeat(newton_iter, n_iters, s, unroll)


def prox_tet_hyper_tuple(f, model: str, mu, lam, kappa, k, n_iters: int = 8,
                         sweeps: int = 8, unroll: bool = True):
    """Hyperelastic prox on a 9-tuple of same-shape arrays (SoA entries).

    Shape-agnostic core shared by the jnp path (arrays shaped [T], loops
    unrolled) and the Pallas kernel (one block of elements, loops kept as
    loops: unroll=False).
    """
    U, S, V = soa.signed_svd3_soa(f, sweeps=sweeps, unroll=unroll)
    s0 = S
    eps = 1e-6
    collapsed = (jnp.abs(S[0]) < eps) & (jnp.abs(S[1]) < eps) & (jnp.abs(S[2]) < eps)
    S = tuple(jnp.where(collapsed, eps, si) for si in S)
    S = (S[0], S[1], jnp.abs(S[2]))

    value, grad, hess = _vgh_soa(model, mu, lam, kappa, k, s0)
    S_opt = newton_soa(value, grad, hess, S, n_iters=n_iters, unroll=unroll)
    return soa.compose_usv(U, S_opt, V)


def prox_tet_hyper_soa(zi, model: str, mu, lam, kappa, k, n_iters: int = 8,
                       sweeps: int = 8):
    """[T,3,3] hyperelastic prox, all internals SoA."""
    out = prox_tet_hyper_tuple(
        soa.unpack33(zi), model, mu, lam, kappa, k, n_iters=n_iters, sweeps=sweeps
    )
    return soa.pack33(out)
