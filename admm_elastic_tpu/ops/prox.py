"""Per-element-family proximal operators (the ADMM local step).

Each function maps a batch of local deformation iterates ``zi = D_i x + u_i``
to the prox of the family's constitutive energy, replacing the reference's
per-element virtual ``EnergyTerm::prox`` calls under an OpenMP loop
(src/Solver.cpp:84-87) with one batched kernel per family.

Models (reference files):
- linear tet (corotation-free projection): src/TetEnergyTerm.cpp:73-92
- NeoHookean / StVK / Xu-spline tets via principal-stretch Newton:
  src/TetEnergyTerm.cpp:114-136, 173-265
- linear tri with hard strain limiting: src/TriEnergyTerm.cpp:73-101
- hard pins: src/SpringEnergyTerm.hpp:61
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from admm_elastic_tpu.materials import (
    SPLINE_COROTATED,
    SPLINE_NEOHOOKEAN,
    SPLINE_STVK,
    spline_dfgh,
    spline_d2fgh,
    spline_fgh,
)
from admm_elastic_tpu.ops.newton import newton_prox
from admm_elastic_tpu.ops.svd3 import (
    polar_rotation_3x2,
    signed_svd3,
    signed_svd3_jacobi,
)

# SVD implementation for the [T,3,3] prox paths, chosen at trace time:
#  - "auto"/"lapack": LAPACK (CPU) / cuSOLVER (GPU) via jnp.linalg.svd —
#    full f64 accuracy for the inversion-recovery goldens; Jacobi on
#    F^T F loses half the digits for near-collapsed elements,
#  - "jacobi": the branch-free batched Jacobi SVD.
# The local step's own choice of path is system.elements.local_step_path,
# which reads the same switch. Set with set_svd_impl before initialize.
_SVD_IMPL = "auto"
_SVD_SWEEPS = 10
_HIGHEST = jax.lax.Precision.HIGHEST


def set_svd_impl(impl: str):
    global _SVD_IMPL
    assert impl in ("auto", "jacobi", "lapack")
    globals()["_SVD_IMPL"] = impl


def _signed_svd(F):
    if _SVD_IMPL == "jacobi":
        return signed_svd3_jacobi(F, sweeps=_SVD_SWEEPS)
    return signed_svd3(F)

# Model ids for tet families (static per family).
TET_LINEAR = "linear"
TET_NEOHOOKEAN = "neohookean"
TET_STVK = "stvk"
TET_SPLINE_NH = "spline_nh"
TET_SPLINE_STVK = "spline_stvk"
TET_SPLINE_COROT = "spline_corot"

_SPLINE_KIND = {
    TET_SPLINE_NH: SPLINE_NEOHOOKEAN,
    TET_SPLINE_STVK: SPLINE_STVK,
    TET_SPLINE_COROT: SPLINE_COROTATED,
}


# ---------------------------------------------------------------------------
# Linear tet
# ---------------------------------------------------------------------------

def prox_tet_linear(zi):
    """Project each F onto the rotation manifold and average.

    zi [T,3,3]. With the signed-SVD convention the reference's
    "flip S[2] if det F < 0 then set singulars to 1" projection
    (src/TetEnergyTerm.cpp:73-92) is exactly proj = U @ V^T (det +1).
    The 0.5(p + zi) blend is valid because w^2 = k * volume.
    """
    U, _, V = _signed_svd(zi)
    proj = jnp.matmul(U, jnp.swapaxes(V, -1, -2), precision=_HIGHEST)
    return 0.5 * (proj + zi)


def energy_tet_linear(F, k, vol):
    """0.5 k V || sigma - 1 ||^2 with unsigned singular values.

    Mirrors src/TetEnergyTerm.cpp:94-101 (plain SVD singular values, all
    nonnegative even for inverted F).
    """
    S = jnp.linalg.svd(F, compute_uv=False)
    return 0.5 * k * vol * jnp.sum((S - 1.0) ** 2, axis=-1)


# ---------------------------------------------------------------------------
# Hyperelastic tets (principal-stretch Newton)
# ---------------------------------------------------------------------------

def _hyper_value_grad_hess(model: str, mu, lam, kappa, k, s0):
    """Build (value, grad, hess) closures for the prox objective
    psi(s) + (k/2)||s - s0||^2 with an s>0 barrier."""

    big = jnp.asarray(jnp.finfo(s0.dtype).max, s0.dtype)

    if model == TET_NEOHOOKEAN:
        # psi = mu/2 (I1 - log I3 - 3) + lambda/8 log^2 I3
        # (src/TetEnergyTerm.cpp:173-204)
        def psi(s):
            J = s[..., 0] * s[..., 1] * s[..., 2]
            I1 = jnp.sum(s * s, axis=-1)
            log_I3 = jnp.log(J * J)
            return 0.5 * mu * (I1 - log_I3 - 3.0) + 0.125 * lam * log_I3 * log_I3

        def grad_psi(s):
            J = s[..., 0] * s[..., 1] * s[..., 2]
            s_inv = 1.0 / s
            return mu[..., None] * (s - s_inv) + (lam * jnp.log(J))[..., None] * s_inv

        def hess_psi(s):
            J = s[..., 0] * s[..., 1] * s[..., 2]
            s_inv = 1.0 / s
            logJ = jnp.log(J)
            diag = mu[..., None] * (1.0 + s_inv * s_inv) + (lam * (1.0 - logJ))[..., None] * s_inv * s_inv
            H = lam[..., None, None] * (s_inv[..., :, None] * s_inv[..., None, :])
            ii = jnp.arange(3)
            H = H.at[..., ii, ii].set(diag)
            return H

    elif model == TET_STVK:
        # psi = mu ||E||^2 + lambda/2 tr(E)^2, E = (s^2 - 1)/2
        # (src/TetEnergyTerm.cpp:210-237)
        def psi(s):
            st = 0.5 * (s * s - 1.0)
            tr = jnp.sum(st, axis=-1)
            return mu * jnp.sum(st * st, axis=-1) + 0.5 * lam * tr * tr

        def grad_psi(s):
            term1 = mu[..., None] * s * (s * s - 1.0)
            term2 = (0.5 * lam * (jnp.sum(s * s, axis=-1) - 3.0))[..., None] * s
            return term1 + term2

        def hess_psi(s):
            sum_s2 = jnp.sum(s * s, axis=-1)
            diag = mu[..., None] * (3.0 * s * s - 1.0) + (0.5 * lam * (sum_s2 - 3.0))[..., None] + lam[..., None] * s * s
            H = lam[..., None, None] * (s[..., :, None] * s[..., None, :])
            ii = jnp.arange(3)
            H = H.at[..., ii, ii].set(diag)
            return H

    elif model in _SPLINE_KIND:
        kind = _SPLINE_KIND[model]

        # psi = sum f(s_i) + sum g(s_i s_j) + h(s1 s2 s3)
        # (src/TetEnergyTerm.cpp:243-265, src/XuSpline.hpp)
        def psi(s):
            s1, s2, s3 = s[..., 0], s[..., 1], s[..., 2]
            J = s1 * s2 * s3
            total = jnp.zeros_like(J)
            for xi in (s1, s2, s3):
                f, _, _ = spline_fgh(kind, xi, xi, jnp.maximum(J, 1e-30), mu, lam, kappa)
                total = total + f
            for pq in (s1 * s2, s2 * s3, s3 * s1):
                _, g, _ = spline_fgh(kind, pq, pq, jnp.maximum(J, 1e-30), mu, lam, kappa)
                total = total + g
            _, _, h = spline_fgh(kind, J, J, jnp.maximum(J, 1e-30), mu, lam, kappa)
            return total + h

        def grad_psi(s):
            s1, s2, s3 = s[..., 0], s[..., 1], s[..., 2]
            J = jnp.maximum(s1 * s2 * s3, 1e-30)
            df1, dg12, dh = spline_dfgh(kind, s1, s1 * s2, J, mu, lam, kappa)
            df2, dg23, _ = spline_dfgh(kind, s2, s2 * s3, J, mu, lam, kappa)
            df3, dg31, _ = spline_dfgh(kind, s3, s3 * s1, J, mu, lam, kappa)
            g1 = df1 + dg12 * s2 + dg31 * s3 + dh * s2 * s3
            g2 = df2 + dg23 * s3 + dg12 * s1 + dh * s3 * s1
            g3 = df3 + dg31 * s1 + dg23 * s2 + dh * s1 * s2
            return jnp.stack([g1, g2, g3], axis=-1)

        def hess_psi(s):
            s1, s2, s3 = s[..., 0], s[..., 1], s[..., 2]
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
            h23 = dg23 + d2g23 * s2 * s3 + d2h * (s3 * s1) * (s1 * s2) + dh * s1
            h13 = dg31 + d2g31 * s3 * s1 + d2h * (s2 * s3) * (s1 * s2) + dh * s2
            row1 = jnp.stack([h11, h12, h13], axis=-1)
            row2 = jnp.stack([h12, h22, h23], axis=-1)
            row3 = jnp.stack([h13, h23, h33], axis=-1)
            return jnp.stack([row1, row2, row3], axis=-2)

    else:
        raise ValueError(f"unknown hyperelastic model {model!r}")

    def value(s):
        infeasible = jnp.any(s <= 0.0, axis=-1)
        quad = 0.5 * k * jnp.sum((s - s0) ** 2, axis=-1)
        v = psi(jnp.maximum(s, 1e-30)) + quad
        return jnp.where(infeasible, big, v)

    def grad(s):
        return grad_psi(s) + k[..., None] * (s - s0)

    def hess(s):
        H = hess_psi(s)
        ii = jnp.arange(3)
        return H.at[..., ii, ii].add(k[..., None])

    return value, grad, hess


def prox_tet_hyper(zi, model: str, mu, lam, kappa, k, n_iters: int = 8):
    """Hyperelastic tet prox: signed SVD -> Newton in stretch space -> rebuild.

    Mirrors HyperElasticTet::prox (src/TetEnergyTerm.cpp:114-136): the quad
    penalty anchor s0 is the *signed* stretch vector; the Newton start is
    eps-inflated if the element collapsed to a point and sign-rectified if
    inverted.
    """
    U, S, V = _signed_svd(zi)
    s0 = S
    eps = 1e-6
    collapsed = jnp.all(jnp.abs(S) < eps, axis=-1, keepdims=True)
    S = jnp.where(collapsed, eps, S)
    S = S.at[..., 2].set(jnp.where(S[..., 2] < 0.0, -S[..., 2], S[..., 2]))

    value, grad, hess = _hyper_value_grad_hess(model, mu, lam, kappa, k, s0)
    S_opt = newton_prox(value, grad, hess, S, n_iters=n_iters)
    return jnp.einsum("...ij,...j,...kj->...ik", U, S_opt, V,
                      precision=_HIGHEST)


def energy_tet_hyper(F, model: str, mu, lam, kappa, k, vol):
    """Per-element energy (volume-scaled), matching HyperElasticTet::energy
    (src/TetEnergyTerm.cpp:139-151) including its quirk that the quadratic
    penalty contributes 4*k/2*S2^2 for inverted elements (x0 is signed, the
    evaluation point has |S2|)."""
    _, S, _ = _signed_svd(F)
    s0 = S
    S = S.at[..., 2].set(jnp.abs(S[..., 2]))
    value, _, _ = _hyper_value_grad_hess(model, mu, lam, kappa, k, s0)
    return value(S) * vol


# ---------------------------------------------------------------------------
# Triangles (cloth)
# ---------------------------------------------------------------------------

def prox_tri(zi, limit_min, limit_max):
    """Linear tri prox + hard strain limiting (src/TriEnergyTerm.cpp:73-101).

    zi [T,3,2]; limits are per-element arrays. Strain limiting clamps the
    norms of the two columns of zi to [limit_min, limit_max] (only when the
    limits are active, exactly like the reference's check_strain).
    """
    P = polar_rotation_3x2(zi)
    zi = 0.5 * (P + zi)

    check = (limit_min > 0.0) | (limit_max < 99.0)  # [T]
    col_norm = jnp.linalg.norm(zi, axis=-2)  # [T, 2]
    scale = jnp.ones_like(col_norm)
    safe = jnp.maximum(col_norm, 1e-30)
    scale = jnp.where(col_norm < limit_min[..., None], limit_min[..., None] / safe, scale)
    scale = jnp.where(col_norm > limit_max[..., None], limit_max[..., None] / safe, scale)
    scale = jnp.where(check[..., None], scale, jnp.ones_like(scale))
    return zi * scale[..., None, :]


def energy_tri(F, k, area):
    """0.5 k a ||F - P||^2 (src/TriEnergyTerm.cpp:104-114)."""
    P = polar_rotation_3x2(F)
    return 0.5 * k * area * jnp.sum((F - P) ** 2, axis=(-2, -1))


# ---------------------------------------------------------------------------
# Pins
# ---------------------------------------------------------------------------

def prox_pin(zi, target, active):
    """Snap to pin target when active, identity otherwise
    (src/SpringEnergyTerm.hpp:61)."""
    return jnp.where(active[..., None], target, zi)
