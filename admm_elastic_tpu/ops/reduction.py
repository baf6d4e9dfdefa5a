"""Matrix-free applies of the ADMM reduction matrix D and its transpose.

The reference assembles a global sparse D (src/Solver.cpp:199-223) and each
energy term slices its row block (src/EnergyTerm.hpp:130-140). We never
materialize D: each element family applies its local reduction as a
gather + small batched contraction, and D^T as the transposed contraction +
segment scatter-add. Per-tet local reduction is the 9x12 operator
S * edges_inv (src/TetEnergyTerm.cpp:50-71); per-tri the 6x9 operator
(src/TriEnergyTerm.cpp:54-70); per-pin the identity rows on the pinned
vertex (src/SpringEnergyTerm.hpp:54-59).

Conventions:
- ``x`` is [N, 3] vertex positions.
- Tet deformation gradients are [T, 3, 3]: F = X @ Dlocal where X is the
  3x4 matrix of the tet's vertex positions and Dlocal = S @ Dm_inv [4, 3].
- Tri deformation gradients are [T, 3, 2]: F = X @ Dlocal, Dlocal [3, 2].
- Pin "deformation" is just the pinned vertex position [P, 3].
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# einsum/matmul contractions run at HIGHEST precision: a default f32
# product may run in reduced precision (TF32 on the GPU), whose error in
# the deformation gradients is visible in trajectories (crossval).
_PP = jax.lax.Precision.HIGHEST


# --- Gather-based transpose apply ---------------------------------------------
#
# Scatter-add with duplicate indices serializes on colliding rows (and sums
# in no fixed order). Since the mesh topology is static, we instead precompute, per
# vertex, the fixed-width list of (element, corner) contributions incident to
# it; D^T then becomes gather + sum over the width axis — pure vectorized
# reads, deterministic summation order, no scatter at all.

def build_gather_table(inds: np.ndarray, n_verts: int) -> np.ndarray:
    """Vertex -> incident (element*arity + corner) table, padded.

    inds: i64/i32 [T, arity] element vertex indices. Returns i32 [N, K]
    where K = max vertex valence; pad entries point at T*arity (callers
    append a zero row at that flat position).
    """
    inds = np.asarray(inds)
    t, arity = inds.shape
    flat = inds.reshape(-1).astype(np.int64)
    order = np.argsort(flat, kind="stable")
    sorted_v = flat[order]
    counts = np.bincount(flat, minlength=n_verts)
    k = int(counts.max()) if counts.size else 1
    starts = np.zeros(n_verts + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    table = np.full((n_verts, max(k, 1)), t * arity, dtype=np.int32)
    within = np.arange(sorted_v.shape[0], dtype=np.int64) - starts[sorted_v]
    table[sorted_v, within] = order.astype(np.int32)
    return table


def dt_gather(contrib, gather_idx):
    """sum of per-corner contributions per vertex: [T*arity, 3] -> [N, 3].

    contrib rows beyond the real corners must not exist — a zero pad row is
    appended here at flat index T*arity (what the table's padding points at).
    """
    flat = jnp.concatenate(
        [contrib, jnp.zeros((1, contrib.shape[1]), dtype=contrib.dtype)], axis=0
    )
    return jnp.sum(flat[gather_idx], axis=1)


# --- Tets -------------------------------------------------------------------

def tet_Dx(x, inds, Dlocal):
    """D_i x for a tet family: F [T,3,3] = sum_j x[inds[t,j]] outer Dlocal[t,j].

    F_{rc} = sum_j x4[t,j,r] * Dlocal[t,j,c].
    """
    x4 = x[inds]  # [T, 4, 3]
    return jnp.einsum("tjr,tjc->trc", x4, Dlocal, precision=_PP)


def tet_Dx_rows(x, inds, Dlocal):
    """D_i x in SoA rows layout: [9, T] (row-major F entries).

    Same math as tet_Dx without ever materializing [T, 3, 3]: each of the
    9 entries is a 4-term elementwise dot, so XLA emits one fusion whose
    output is already in the lane-packed layout the SoA/Pallas local step
    consumes — no transposes.
    """
    x4 = x[inds]  # [T, 4, 3]
    rows = [
        sum(x4[:, j, r] * Dlocal[:, j, c] for j in range(4))
        for r in range(3)
        for c in range(3)
    ]
    return jnp.stack(rows, axis=0)


def tet_Dt_rows(G_rows, inds, Dlocal, n_verts, gather_idx=None):
    """D_i^T G from SoA rows [9, T] into [N, 3] (see tet_Dt)."""
    # contrib[t, j, r] = sum_c G[r, c][t] * Dlocal[t, j, c]
    contrib = jnp.stack(
        [
            sum(G_rows[3 * r + c] * Dlocal[:, j, c] for c in range(3))
            for j in range(4)
            for r in range(3)
        ],
        axis=1,
    ).reshape(-1, 3)  # [T*4, 3] (j-major, matching inds.reshape(-1))
    if gather_idx is not None:
        return dt_gather(contrib, gather_idx)
    out = jnp.zeros((n_verts, 3), dtype=contrib.dtype)
    return out.at[inds.reshape(-1)].add(contrib)


def tet_Dt(G, inds, Dlocal, n_verts, gather_idx=None):
    """D_i^T G into a [N,3] vector; G is [T,3,3].

    With gather_idx (precomputed build_gather_table), uses the scatter-free
    gather-sum path; otherwise falls back to scatter-add.
    """
    contrib = jnp.einsum("trc,tjc->tjr", G, Dlocal, precision=_PP)  # [T, 4, 3]
    if gather_idx is not None:
        return dt_gather(contrib.reshape(-1, 3), gather_idx)
    out = jnp.zeros((n_verts, 3), dtype=G.dtype)
    return out.at[inds.reshape(-1)].add(contrib.reshape(-1, 3))


def tet_diag(weight2, Dlocal, inds, n_verts):
    """diag(D^T W^2 D) per-vertex (one scalar per vertex; all 3 comps equal)."""
    d = weight2[:, None] * jnp.sum(Dlocal * Dlocal, axis=-1)  # [T, 4]
    out = jnp.zeros((n_verts,), dtype=Dlocal.dtype)
    return out.at[inds.reshape(-1)].add(d.reshape(-1))


# --- Triangles ---------------------------------------------------------------

def tri_Dx(x, inds, Dlocal):
    """D_i x for a tri family: F [T,3,2]."""
    x3 = x[inds]  # [T, 3, 3]
    return jnp.einsum("tjr,tjc->trc", x3, Dlocal, precision=_PP)


def tri_Dx_rows(x, inds, Dlocal):
    """D_i x for a tri family in SoA rows: [6, T] (row-major 3x2 entries)."""
    x3 = x[inds]  # [T, 3, 3]
    rows = [
        sum(x3[:, j, r] * Dlocal[:, j, c] for j in range(3))
        for r in range(3)
        for c in range(2)
    ]
    return jnp.stack(rows, axis=0)


def tri_Dt_rows(G_rows, inds, Dlocal, n_verts, gather_idx=None):
    """D_i^T G from SoA rows [6, T] into [N, 3]."""
    contrib = jnp.stack(
        [
            sum(G_rows[2 * r + c] * Dlocal[:, j, c] for c in range(2))
            for j in range(3)
            for r in range(3)
        ],
        axis=1,
    ).reshape(-1, 3)  # [T*3, 3] j-major
    if gather_idx is not None:
        return dt_gather(contrib, gather_idx)
    out = jnp.zeros((n_verts, 3), dtype=contrib.dtype)
    return out.at[inds.reshape(-1)].add(contrib)


def tri_Dt(G, inds, Dlocal, n_verts, gather_idx=None):
    """D_i^T G into [N,3]; G is [T,3,2]. See tet_Dt for the two paths."""
    contrib = jnp.einsum("trc,tjc->tjr", G, Dlocal, precision=_PP)  # [T, 3, 3]
    if gather_idx is not None:
        return dt_gather(contrib.reshape(-1, 3), gather_idx)
    out = jnp.zeros((n_verts, 3), dtype=G.dtype)
    return out.at[inds.reshape(-1)].add(contrib.reshape(-1, 3))


def tri_diag(weight2, Dlocal, inds, n_verts):
    d = weight2[:, None] * jnp.sum(Dlocal * Dlocal, axis=-1)  # [T, 3]
    out = jnp.zeros((n_verts,), dtype=Dlocal.dtype)
    return out.at[inds.reshape(-1)].add(d.reshape(-1))


# --- Pins --------------------------------------------------------------------

def pin_Dx(x, idx):
    """[P,3] positions of pinned vertices (identity reduction rows)."""
    return x[idx]


def pin_Dt(G, idx, n_verts, gather_idx=None):
    if gather_idx is not None:
        return dt_gather(G, gather_idx)
    out = jnp.zeros((n_verts, 3), dtype=G.dtype)
    return out.at[idx].add(G)


def pin_diag(weight2, idx, n_verts):
    out = jnp.zeros((n_verts,), dtype=weight2.dtype)
    return out.at[idx].add(weight2)
