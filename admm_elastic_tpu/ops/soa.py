"""Structure-of-arrays (SoA) forms of the per-element kernels.

Layout rationale: a batched [T, 3, 3] tensor keeps the 9 entries of one
element together, so every elementwise op strides over tiny trailing
dims. Representing each matrix entry as its own [T] array makes every
op a contiguous stream over the element axis — the layout the fused
local-step kernel (ops/pallas_kernels.py) reads. These SoA kernels are
the hot path of the ADMM local step (the reference's OpenMP elementwise
loop, src/Solver.cpp:84-87).

Matrices are tuples in row-major entry order:
  mat3:  (m11, m12, m13, m21, m22, m23, m31, m32, m33), each [T]
  vec3:  (v1, v2, v3)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


# --- packing ----------------------------------------------------------------

def unpack33(M):
    """[T, 3, 3] -> 9-tuple of [T]."""
    return tuple(M[..., r, c] for r in range(3) for c in range(3))


def pack33(m):
    """9-tuple of [T] -> [T, 3, 3]."""
    rows = [jnp.stack(m[3 * r: 3 * r + 3], axis=-1) for r in range(3)]
    return jnp.stack(rows, axis=-2)


def unpack3(v):
    return tuple(v[..., i] for i in range(3))


def pack3(v):
    return jnp.stack(v, axis=-1)


# --- small algebra ------------------------------------------------------------

def matmul33(a, b):
    (a11, a12, a13, a21, a22, a23, a31, a32, a33) = a
    (b11, b12, b13, b21, b22, b23, b31, b32, b33) = b
    return (
        a11 * b11 + a12 * b21 + a13 * b31,
        a11 * b12 + a12 * b22 + a13 * b32,
        a11 * b13 + a12 * b23 + a13 * b33,
        a21 * b11 + a22 * b21 + a23 * b31,
        a21 * b12 + a22 * b22 + a23 * b32,
        a21 * b13 + a22 * b23 + a23 * b33,
        a31 * b11 + a32 * b21 + a33 * b31,
        a31 * b12 + a32 * b22 + a33 * b32,
        a31 * b13 + a32 * b23 + a33 * b33,
    )


def transpose33(a):
    (a11, a12, a13, a21, a22, a23, a31, a32, a33) = a
    return (a11, a21, a31, a12, a22, a32, a13, a23, a33)


def matmul33_nt(a, b):
    """a @ b^T."""
    return matmul33(a, transpose33(b))


def matmul33_tn(a, b):
    """a^T @ b."""
    return matmul33(transpose33(a), b)


def det3_soa(a):
    (a11, a12, a13, a21, a22, a23, a31, a32, a33) = a
    return (
        a11 * (a22 * a33 - a23 * a32)
        - a12 * (a21 * a33 - a23 * a31)
        + a13 * (a21 * a32 - a22 * a31)
    )


def cross3(u, v):
    return (
        u[1] * v[2] - u[2] * v[1],
        u[2] * v[0] - u[0] * v[2],
        u[0] * v[1] - u[1] * v[0],
    )


def dot3(u, v):
    return u[0] * v[0] + u[1] * v[1] + u[2] * v[2]


def col(a, j):
    return (a[j], a[3 + j], a[6 + j])


def from_cols(c0, c1, c2):
    return (c0[0], c1[0], c2[0], c0[1], c1[1], c2[1], c0[2], c1[2], c2[2])


def repeat(body, n, init, unroll):
    """n applications of body: Python-unrolled (one straight-line graph
    for XLA to fuse) or a lax.fori_loop (a small loop body, which keeps
    the Pallas kernel's compile short)."""
    if unroll:
        for _ in range(n):
            init = body(init)
        return init
    return jax.lax.fori_loop(0, n, lambda _, c: body(c), init)


# --- Jacobi eigendecomposition of symmetric 3x3 (SoA) -------------------------

def _rot_pq(s6, V, p, q):
    """One Jacobi rotation zeroing the (p,q) entry of the symmetric matrix.

    s6 = (a11, a22, a33, a12, a13, a23); V is a 9-tuple (columns are
    eigenvector estimates). Returns updated (s6, V).
    """
    a11, a22, a33, a12, a13, a23 = s6
    diag = {0: a11, 1: a22, 2: a33}
    off = {(0, 1): a12, (0, 2): a13, (1, 2): a23}

    apq = off[(p, q)]
    app = diag[p]
    aqq = diag[q]
    zero = apq == 0.0
    theta = (aqq - app) / (2.0 * jnp.where(zero, 1.0, apq))
    # |theta| is clamped: XLA:CPU f64 sqrt() returns NaN for args >~1e49
    # (observed with jax 0.9.0), and for |theta| > ~1e8 the rotation is
    # t = 1/(2 theta) to machine precision anyway, so clamping at 1e15 is
    # mathematically lossless.
    theta = jnp.clip(theta, -1e15, 1e15)
    t = jnp.sign(theta) / (jnp.abs(theta) + jnp.sqrt(theta * theta + 1.0))
    t = jnp.where(zero, 0.0, t)
    c = 1.0 / jnp.sqrt(t * t + 1.0)
    s = t * c

    r = 3 - p - q  # the untouched index
    arp = off[(min(r, p), max(r, p))]
    arq = off[(min(r, q), max(r, q))]

    new_pp = c * c * app - 2.0 * s * c * apq + s * s * aqq
    new_qq = s * s * app + 2.0 * s * c * apq + c * c * aqq
    new_rp = c * arp - s * arq
    new_rq = s * arp + c * arq

    diag[p] = new_pp
    diag[q] = new_qq
    off[(p, q)] = jnp.zeros_like(apq)
    off[(min(r, p), max(r, p))] = new_rp
    off[(min(r, q), max(r, q))] = new_rq
    s6_new = (diag[0], diag[1], diag[2], off[(0, 1)], off[(0, 2)], off[(1, 2)])

    # V <- V @ G where G rotates columns p and q.
    vp = col(V, p)
    vq = col(V, q)
    new_vp = tuple(c * a - s * b for a, b in zip(vp, vq))
    new_vq = tuple(s * a + c * b for a, b in zip(vp, vq))
    cols = [col(V, 0), col(V, 1), col(V, 2)]
    cols[p] = new_vp
    cols[q] = new_vq
    return s6_new, from_cols(*cols)


def jacobi_eigh3_soa(s6, sweeps: int, unroll: bool = True):
    """Eigendecomposition of a batch of symmetric 3x3 in SoA form.

    s6 = (a11, a22, a33, a12, a13, a23). Returns (V 9-tuple, w 3-tuple).
    unroll=False keeps the sweeps as a lax.fori_loop (see repeat).
    """
    one = jnp.ones_like(s6[0])
    zero = jnp.zeros_like(s6[0])
    V = (one, zero, zero, zero, one, zero, zero, zero, one)

    def sweep(carry):
        s6, V = carry
        for (p, q) in ((0, 1), (0, 2), (1, 2)):
            s6, V = _rot_pq(s6, V, p, q)
        return s6, V

    s6, V = repeat(sweep, sweeps, (s6, V), unroll)
    return V, (s6[0], s6[1], s6[2])


def signed_svd3_soa(f, sweeps: int = 8, unroll: bool = True):
    """Branch-free signed SVD in SoA form: f 9-tuple -> (U, S, V).

    Same algorithm/convention as svd3.signed_svd3_jacobi: det(U), det(V) > 0,
    inversion sign on S[2], singular values sorted descending by magnitude.
    """
    dtype = f[0].dtype
    eps = jnp.asarray(1e-12 if dtype == jnp.float64 else 1e-8, dtype)

    ftf = matmul33_tn(f, f)
    # Symmetric compact form.
    s6 = (ftf[0], ftf[4], ftf[8], ftf[1], ftf[2], ftf[5])
    V, w = jacobi_eigh3_soa(s6, sweeps, unroll)

    # Sort eigenpairs descending (3-element network).
    def swap(V, w, i, j):
        cond = w[i] < w[j]
        wl = list(w)
        wl[i] = jnp.where(cond, w[j], w[i])
        wl[j] = jnp.where(cond, w[i], w[j])
        cols = [col(V, 0), col(V, 1), col(V, 2)]
        ci = tuple(jnp.where(cond, b, a) for a, b in zip(cols[i], cols[j]))
        cj = tuple(jnp.where(cond, a, b) for a, b in zip(cols[i], cols[j]))
        cols[i], cols[j] = ci, cj
        return from_cols(*cols), tuple(wl)

    V, w = swap(V, w, 0, 1)
    V, w = swap(V, w, 0, 2)
    V, w = swap(V, w, 1, 2)

    S = tuple(jnp.sqrt(jnp.maximum(wi, 0.0)) for wi in w)

    # U = F V / S with orthonormalization fallbacks.
    fv = matmul33(f, V)
    u0 = tuple(fv[3 * r] / jnp.maximum(S[0], eps) for r in range(3))
    u1 = tuple(fv[3 * r + 1] / jnp.maximum(S[1], eps) for r in range(3))

    n0 = jnp.sqrt(dot3(u0, u0))
    ok0 = n0 > eps
    inv0 = 1.0 / jnp.maximum(n0, eps)
    e0 = (jnp.ones_like(n0), jnp.zeros_like(n0), jnp.zeros_like(n0))
    u0 = tuple(jnp.where(ok0, a * inv0, e) for a, e in zip(u0, e0))

    proj = dot3(u1, u0)
    u1 = tuple(a - proj * b for a, b in zip(u1, u0))
    n1 = jnp.sqrt(dot3(u1, u1))
    ok1 = n1 > eps
    inv1 = 1.0 / jnp.maximum(n1, eps)
    # Fallback orthogonal direction.
    big0 = jnp.abs(u0[0]) > 0.9
    alt_ref = (
        jnp.where(big0, 0.0, 1.0),
        jnp.where(big0, 1.0, 0.0),
        jnp.zeros_like(n1),
    )
    alt = cross3(u0, alt_ref)
    altn = jnp.sqrt(jnp.maximum(dot3(alt, alt), eps * eps))
    alt = tuple(a / altn for a in alt)
    u1 = tuple(jnp.where(ok1, a * inv1, b) for a, b in zip(u1, alt))
    u2 = cross3(u0, u1)
    U = from_cols(u0, u1, u2)

    detV = det3_soa(V)
    flipV = jnp.where(detV < 0.0, -1.0, 1.0)
    cols = [col(V, 0), col(V, 1), tuple(flipV * a for a in col(V, 2))]
    V = from_cols(*cols)

    detF = det3_soa(f)
    S = (S[0], S[1], S[2] * jnp.where(detF < 0.0, -1.0, 1.0))
    return U, S, V


def compose_usv(U, S, V):
    """U @ diag(S) @ V^T in SoA form."""
    US = from_cols(
        tuple(S[0] * a for a in col(U, 0)),
        tuple(S[1] * a for a in col(U, 1)),
        tuple(S[2] * a for a in col(U, 2)),
    )
    return matmul33_nt(US, V)


# --- SoA prox kernels ----------------------------------------------------------

def prox_tet_linear_tuple(f, sweeps: int = 8):
    """Linear-tet prox on a 9-tuple of same-shape arrays (SoA entries)."""
    U, _, V = signed_svd3_soa(f, sweeps=sweeps)
    proj = matmul33_nt(U, V)
    return tuple(0.5 * (p + z) for p, z in zip(proj, f))


def prox_tet_linear_soa(zi, sweeps: int = 8):
    """[T,3,3] -> [T,3,3], all internals in SoA layout."""
    return pack33(prox_tet_linear_tuple(unpack33(zi), sweeps=sweeps))


def solve3x3_sym_soa(h6, g):
    """Solve symmetric 3x3 systems: h6=(h11,h22,h33,h12,h13,h23), g vec3."""
    a, d, f2, b, c, e = h6
    A = d * f2 - e * e
    B = c * e - b * f2
    C = b * e - c * d
    D = a * f2 - c * c
    E = b * c - a * e
    F = a * d - b * b
    det = a * A + b * B + c * C
    inv = 1.0 / jnp.where(jnp.abs(det) < 1e-300, 1.0, det)
    return (
        (A * g[0] + B * g[1] + C * g[2]) * inv,
        (B * g[0] + D * g[1] + E * g[2]) * inv,
        (C * g[0] + E * g[1] + F * g[2]) * inv,
    ), det


# --- 3x2 (cloth) SoA kernels ---------------------------------------------------
#
# Rows layout for [T, 3, 2] deformation gradients: 6-tuple / [6, T] array in
# row-major entry order (F00, F01, F10, F11, F20, F21).

def polar_rotation_3x2_tuple(f):
    """Closest orthonormal-column 3x2 to F, on a 6-tuple of same-shape
    arrays. Same algorithm/fallbacks as svd3.polar_rotation_3x2."""
    f00, f01, f10, f11, f20, f21 = f
    dtype = f00.dtype
    eps = jnp.asarray(1e-12 if dtype == jnp.float64 else 1e-7, dtype)

    # G = F^T F (2x2 SPD)
    a = f00 * f00 + f10 * f10 + f20 * f20
    b = f00 * f01 + f10 * f11 + f20 * f21
    c = f01 * f01 + f11 * f11 + f21 * f21

    tr = a + c
    disc = jnp.sqrt(jnp.maximum((a - c) ** 2 + 4.0 * b * b, 0.0))
    l1 = 0.5 * (tr + disc)
    l2 = 0.5 * (tr - disc)

    v1x, v1y = b, l1 - a
    ax_, ay_ = l1 - c, b
    use_alt = v1x * v1x + v1y * v1y < ax_ * ax_ + ay_ * ay_
    v1x = jnp.where(use_alt, ax_, v1x)
    v1y = jnp.where(use_alt, ay_, v1y)
    n1 = jnp.sqrt(v1x * v1x + v1y * v1y)
    ok = n1 > eps
    inv = 1.0 / jnp.maximum(n1, eps)
    v1x = jnp.where(ok, v1x * inv, 1.0)
    v1y = jnp.where(ok, v1y * inv, 0.0)
    v2x, v2y = -v1y, v1x
    s1 = jnp.sqrt(jnp.maximum(l1, 0.0))
    s2 = jnp.sqrt(jnp.maximum(l2, 0.0))

    # U columns = F V / s with orthonormalization fallbacks.
    u1 = (f00 * v1x + f01 * v1y, f10 * v1x + f11 * v1y, f20 * v1x + f21 * v1y)
    u2 = (f00 * v2x + f01 * v2y, f10 * v2x + f11 * v2y, f20 * v2x + f21 * v2y)
    inv1 = 1.0 / jnp.maximum(s1, eps)
    inv2 = 1.0 / jnp.maximum(s2, eps)
    u1 = tuple(x * inv1 for x in u1)
    u2 = tuple(x * inv2 for x in u2)

    nu1 = jnp.sqrt(dot3(u1, u1))
    ok1 = nu1 > eps
    iu1 = 1.0 / jnp.maximum(nu1, eps)
    ex = (jnp.ones_like(nu1), jnp.zeros_like(nu1), jnp.zeros_like(nu1))
    u1 = tuple(jnp.where(ok1, x * iu1, e) for x, e in zip(u1, ex))

    proj = dot3(u2, u1)
    u2 = tuple(x - proj * y for x, y in zip(u2, u1))
    nu2 = jnp.sqrt(dot3(u2, u2))
    ok2 = nu2 > eps
    iu2 = 1.0 / jnp.maximum(nu2, eps)
    big0 = jnp.abs(u1[0]) > 0.9
    ref = (jnp.where(big0, 0.0, 1.0), jnp.where(big0, 1.0, 0.0), jnp.zeros_like(nu2))
    alt = cross3(u1, ref)
    altn = jnp.sqrt(jnp.maximum(dot3(alt, alt), eps * eps))
    alt = tuple(x / altn for x in alt)
    u2 = tuple(jnp.where(ok2, x * iu2, y) for x, y in zip(u2, alt))

    # P = U V^T (3x2): P_rc = u1_r * v1_c + u2_r * v2_c.
    return (
        u1[0] * v1x + u2[0] * v2x, u1[0] * v1y + u2[0] * v2y,
        u1[1] * v1x + u2[1] * v2x, u1[1] * v1y + u2[1] * v2y,
        u1[2] * v1x + u2[2] * v2x, u1[2] * v1y + u2[2] * v2y,
    )


def prox_tri_tuple(f, limit_min, limit_max):
    """Cloth prox + hard strain limiting on a 6-tuple
    (src/TriEnergyTerm.cpp:73-101; matches ops/prox.prox_tri)."""
    p = polar_rotation_3x2_tuple(f)
    z = tuple(0.5 * (pi + fi) for pi, fi in zip(p, f))
    z00, z01, z10, z11, z20, z21 = z

    check = (limit_min > 0.0) | (limit_max < 99.0)
    n0 = jnp.sqrt(z00 * z00 + z10 * z10 + z20 * z20)
    n1 = jnp.sqrt(z01 * z01 + z11 * z11 + z21 * z21)

    def clamp(n):
        safe = jnp.maximum(n, 1e-30)
        s = jnp.ones_like(n)
        s = jnp.where(n < limit_min, limit_min / safe, s)
        s = jnp.where(n > limit_max, limit_max / safe, s)
        return jnp.where(check, s, jnp.ones_like(s))

    s0 = clamp(n0)
    s1 = clamp(n1)
    return (z00 * s0, z01 * s1, z10 * s0, z11 * s1, z20 * s0, z21 * s1)
