"""Batched signed SVD of 3x3 (and thin SVD of 3x2) matrices.

The "signed SVD" convention follows Irving et al. (invertible FEM), as in
the reference's FastSVD (src/FastSVD.hpp:43-68): ``F = U diag(S) V^T`` with
``det U > 0`` and ``det V > 0``; any reflection is pushed into ``S[2]``,
which becomes negative when F is inverted.

Two implementations:

- :func:`signed_svd3` — wraps ``jnp.linalg.svd`` (LAPACK on CPU,
  cuSOLVER on GPU), then applies the sign fix. Bit-accurate, used for
  correctness tests.
- :func:`signed_svd3_jacobi` — branch-free batched one-sided/two-sided
  Jacobi built from fixed-count sweeps, the batched fast path (the McAdams et
  al. "minimal branching" scheme the reference cites as its intended fast
  path at src/FastSVD.hpp:21-34, redesigned for SIMD batching rather than
  scalar code). Accurate to ~1e-6 relative in f32 after 6 sweeps.

All functions are batched over leading axes ([..., 3, 3]).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# All small batched matmuls here run at HIGHEST precision: a default f32
# matmul may run in reduced precision (TF32 on the GPU), whose error in
# the Gram matrices / rotation composition corrupts trajectories.
_PP = jax.lax.Precision.HIGHEST


def det3(M):
    """Pure-arithmetic 3x3 determinant (batched).

    jnp.linalg.det lowers to an LU custom call on CPU; besides being slow
    for 3x3, XLA:CPU (jax 0.9.0) miscompiles fusions that mix LAPACK custom
    calls (observed: svd + det + elementwise in one jit produced corrupt
    output while each op alone was correct). All 3x3 determinants in the
    compute path use this closed form instead.
    """
    r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    return jnp.sum(r0 * jnp.cross(r1, r2), axis=-1)


def inv3(M, eps: float = 0.0):
    """Pure-arithmetic 3x3 inverse via the adjugate (batched)."""
    d = det3(M)
    safe = jnp.where(jnp.abs(d) < 1e-300, 1.0, d)
    c0 = jnp.cross(M[..., 1, :], M[..., 2, :])
    c1 = jnp.cross(M[..., 2, :], M[..., 0, :])
    c2 = jnp.cross(M[..., 0, :], M[..., 1, :])
    adjT = jnp.stack([c0, c1, c2], axis=-1)  # columns are cofactor rows
    return adjT / safe[..., None, None]


def _fix_signs(U, S, V):
    """Push reflections of U/V into S[..., 2] so det(U)>0 and det(V)>0."""
    detU = det3(U)
    detV = det3(V)
    flipU = jnp.where(detU < 0.0, -1.0, 1.0)
    flipV = jnp.where(detV < 0.0, -1.0, 1.0)
    U = U.at[..., :, 2].mul(flipU[..., None])
    V = V.at[..., :, 2].mul(flipV[..., None])
    S = S.at[..., 2].mul(flipU * flipV)
    return U, S, V


def signed_svd3(F):
    """Signed SVD of [..., 3, 3]: returns (U, S, V) with F = U @ diag(S) @ V^T.

    det(U) > 0, det(V) > 0; S[...,0] >= S[...,1] >= |S[...,2]|, and
    S[...,2] < 0 iff det(F) < 0. Mirrors src/FastSVD.hpp:43-68.
    """
    U, S, Vt = jnp.linalg.svd(F, full_matrices=False)
    V = jnp.swapaxes(Vt, -1, -2)
    return _fix_signs(U, S, V)


# ---------------------------------------------------------------------------
# Branch-free batched Jacobi SVD
# ---------------------------------------------------------------------------


def _jacobi_eigh3(A, sweeps: int = 6):
    """Batched eigendecomposition of symmetric 3x3 via cyclic Jacobi.

    Returns (Q, w) with A ~= Q diag(w) Q^T. Branch-free: each rotation is
    computed with jnp.where masks, so the whole thing vectorizes over the
    batch. ``sweeps`` fixed -> static control flow under jit.
    """
    dtype = A.dtype
    batch_shape = A.shape[:-2]
    Q = jnp.broadcast_to(jnp.eye(3, dtype=dtype), batch_shape + (3, 3))

    def rot(A, Q, p, q):
        # Compute Jacobi rotation zeroing A[p,q].
        apq = A[..., p, q]
        app = A[..., p, p]
        aqq = A[..., q, q]
        # Stable tangent computation.
        theta = (aqq - app) / (2.0 * jnp.where(apq == 0.0, 1.0, apq))
        # |theta| is clamped: XLA:CPU f64 sqrt() returns NaN for args >~1e49
        # (observed with jax 0.9.0), and for |theta| > ~1e8 the rotation is
        # t = 1/(2 theta) to machine precision anyway, so clamping at 1e15 is
        # mathematically lossless.
        theta = jnp.clip(theta, -1e15, 1e15)
        t = jnp.sign(theta) / (jnp.abs(theta) + jnp.sqrt(theta * theta + 1.0))
        t = jnp.where(apq == 0.0, 0.0, t)
        c = 1.0 / jnp.sqrt(t * t + 1.0)
        s = t * c
        # Build batched Givens rotation G (identity + updates at p,q).
        G = jnp.zeros_like(A)
        eye = jnp.broadcast_to(jnp.eye(3, dtype=dtype), A.shape)
        G = eye.at[..., p, p].set(c).at[..., q, q].set(c)
        G = G.at[..., p, q].set(s).at[..., q, p].set(-s)
        A = jnp.matmul(jnp.matmul(jnp.swapaxes(G, -1, -2), A, precision=_PP), G, precision=_PP)
        Q = jnp.matmul(Q, G, precision=_PP)
        return A, Q

    for _ in range(sweeps):
        for (p, q) in ((0, 1), (0, 2), (1, 2)):
            A, Q = rot(A, Q, p, q)
    w = jnp.stack([A[..., 0, 0], A[..., 1, 1], A[..., 2, 2]], axis=-1)
    return Q, w


def signed_svd3_jacobi(F, sweeps: int = 6):
    """Branch-free signed SVD via Jacobi eigh of F^T F + QR-style polar fix.

    Algorithm (batched, no data-dependent branching):
      1. eigh(F^T F) = (V, w) by cyclic Jacobi sweeps,
      2. sort eigenpairs descending with masked swaps,
      3. singular values s = sqrt(max(w, 0)),
      4. U = F V / s column-wise, with Gram-Schmidt fallback for tiny s,
      5. sign fix as in :func:`_fix_signs`.
    """
    dtype = F.dtype
    FtF = jnp.matmul(jnp.swapaxes(F, -1, -2), F, precision=_PP)
    V, w = _jacobi_eigh3(FtF, sweeps=sweeps)

    # Sort eigenvalues descending (3-element sorting network, masked swaps).
    def swap(V, w, i, j):
        cond = w[..., i] < w[..., j]
        wi, wj = w[..., i], w[..., j]
        w = w.at[..., i].set(jnp.where(cond, wj, wi))
        w = w.at[..., j].set(jnp.where(cond, wi, wj))
        vi, vj = V[..., :, i], V[..., :, j]
        V = V.at[..., :, i].set(jnp.where(cond[..., None], vj, vi))
        V = V.at[..., :, j].set(jnp.where(cond[..., None], vi, vj))
        return V, w

    V, w = swap(V, w, 0, 1)
    V, w = swap(V, w, 0, 2)
    V, w = swap(V, w, 1, 2)

    S = jnp.sqrt(jnp.maximum(w, 0.0))

    # U columns = F v_i / s_i; degenerate columns re-orthonormalized by
    # cross products (handles rank-deficient / collapsed elements).
    eps = jnp.asarray(1e-12 if dtype == jnp.float64 else 1e-8, dtype)
    FV = jnp.matmul(F, V, precision=_PP)
    safe = jnp.maximum(S, eps)
    U = FV / safe[..., None, :]

    # Re-orthonormalize: u0 normalized; u1 orthogonal to u0; u2 = u0 x u1.
    u0 = U[..., :, 0]
    n0 = jnp.linalg.norm(u0, axis=-1, keepdims=True)
    # If u0 is degenerate (F ~ 0) fall back to e0.
    e0 = jnp.broadcast_to(jnp.asarray([1.0, 0.0, 0.0], u0.dtype), u0.shape)
    u0 = jnp.where(n0 > eps, u0 / jnp.maximum(n0, eps), e0)
    u1 = U[..., :, 1]
    u1 = u1 - jnp.sum(u1 * u0, axis=-1, keepdims=True) * u0
    n1 = jnp.linalg.norm(u1, axis=-1, keepdims=True)
    # Fallback: any vector orthogonal to u0.
    alt = jnp.cross(u0, jnp.where(jnp.abs(u0[..., :1]) > 0.9, jnp.broadcast_to(jnp.asarray([0.0, 1.0, 0.0], u0.dtype), u0.shape), e0))
    altn = alt / jnp.maximum(jnp.linalg.norm(alt, axis=-1, keepdims=True), eps)
    u1 = jnp.where(n1 > eps, u1 / jnp.maximum(n1, eps), altn)
    u2 = jnp.cross(u0, u1)
    U = jnp.stack([u0, u1, u2], axis=-1)

    # det(V) sign: make det(V) > 0 by flipping V's last column.
    detV = det3(V)
    V = V.at[..., :, 2].mul(jnp.where(detV < 0.0, -1.0, 1.0)[..., None])
    # U built via cross product always has det(U) = +1. Inversion goes to S[2]:
    detF = det3(F)
    S = S.at[..., 2].mul(jnp.where(detF < 0.0, -1.0, 1.0))
    return U, S, V


def svd_3x2(F):
    """Thin SVD of [..., 3, 2] (cloth deformation gradients).

    Returns (U [...,3,2], S [...,2], V [...,2,2]) with F = U diag(S) V^T.
    Used by the triangle prox (reference: src/TriEnergyTerm.cpp:73-101).
    """
    U, S, Vt = jnp.linalg.svd(F, full_matrices=False)
    return U, S, jnp.swapaxes(Vt, -1, -2)


def polar_rotation_3x2(F):
    """Closest 3x2 matrix with orthonormal columns to F (batch).

    Equivalent to U @ [I2; 0] @ V^T from the thin SVD — the projection the
    triangle prox needs (src/TriEnergyTerm.cpp:79-84) — computed directly
    from the 2x2 symmetric eigendecomposition of F^T F (batched, no
    LAPACK). Degenerate (collapsed) triangles fall back to Gram-Schmidt.
    """
    dtype = F.dtype
    eps = jnp.asarray(1e-12 if dtype == jnp.float64 else 1e-7, dtype)
    G = jnp.matmul(jnp.swapaxes(F, -1, -2), F, precision=_PP)  # [..., 2, 2] SPD
    a = G[..., 0, 0]
    b = G[..., 0, 1]
    c = G[..., 1, 1]
    # Closed-form 2x2 eigendecomposition.
    tr = a + c
    disc = jnp.sqrt(jnp.maximum((a - c) ** 2 + 4.0 * b * b, 0.0))
    l1 = 0.5 * (tr + disc)
    l2 = 0.5 * (tr - disc)
    # Eigenvector for l1.
    v1 = jnp.stack([b, l1 - a], axis=-1)
    v1_alt = jnp.stack([l1 - c, b], axis=-1)
    use_alt = jnp.sum(v1 * v1, axis=-1, keepdims=True) < jnp.sum(v1_alt * v1_alt, axis=-1, keepdims=True)
    v1 = jnp.where(use_alt, v1_alt, v1)
    n1 = jnp.linalg.norm(v1, axis=-1, keepdims=True)
    e1 = jnp.broadcast_to(jnp.asarray([1.0, 0.0], v1.dtype), v1.shape)
    v1 = jnp.where(n1 > eps, v1 / jnp.maximum(n1, eps), e1)
    v2 = jnp.stack([-v1[..., 1], v1[..., 0]], axis=-1)
    V = jnp.stack([v1, v2], axis=-1)  # [..., 2, 2]
    s1 = jnp.sqrt(jnp.maximum(l1, 0.0))
    s2 = jnp.sqrt(jnp.maximum(l2, 0.0))

    # U columns.
    FV = jnp.matmul(F, V, precision=_PP)  # [..., 3, 2]
    u1 = FV[..., :, 0] / jnp.maximum(s1, eps)[..., None]
    u2 = FV[..., :, 1] / jnp.maximum(s2, eps)[..., None]
    # Orthonormalize/fallback.
    n_u1 = jnp.linalg.norm(u1, axis=-1, keepdims=True)
    ex = jnp.broadcast_to(jnp.asarray([1.0, 0.0, 0.0], u1.dtype), u1.shape)
    ey = jnp.broadcast_to(jnp.asarray([0.0, 1.0, 0.0], u1.dtype), u1.shape)
    u1 = jnp.where(n_u1 > eps, u1 / jnp.maximum(n_u1, eps), ex)
    u2 = u2 - jnp.sum(u2 * u1, axis=-1, keepdims=True) * u1
    n_u2 = jnp.linalg.norm(u2, axis=-1, keepdims=True)
    alt = jnp.cross(u1, jnp.where(jnp.abs(u1[..., :1]) > 0.9, ey, ex))
    altn = alt / jnp.maximum(jnp.linalg.norm(alt, axis=-1, keepdims=True), eps)
    u2 = jnp.where(n_u2 > eps, u2 / jnp.maximum(n_u2, eps), altn)
    U = jnp.stack([u1, u2], axis=-1)  # [..., 3, 2]
    return jnp.matmul(U, jnp.swapaxes(V, -1, -2), precision=_PP)
