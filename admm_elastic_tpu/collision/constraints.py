"""Fixed-capacity masked constraint buffers and matrix-free C applies.

The reference builds a sparse constraint matrix C x = c from the hit lists
every solve (ConstraintSet::make_matrix, src/ConstraintSet.hpp:59-116).
Hit counts change every ADMM iteration, which would retrace under jit, so
here the buffers have *fixed capacity* (one slot per surface vertex: the
reference payloads keep at most one passive and one dynamic hit per vertex)
and a boolean mask; C and C^T are applied matrix-free from the buffers.

Row conventions (matching make_matrix):
- passive row r:  ck * n_r . x_{v_r}  =  ck * n_r . p_r
- dynamic row r:  ck * n_r . (x_{v_r} - sum_j barys_j x_{f_rj}) = 0
- a vertex with both a passive and a dynamic hit keeps only the passive row
  (the reference's `constrained[]` dedup, src/ConstraintSet.hpp:77-99).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class Hits:
    """Per-surface-vertex hit slots. H = number of surface vertices."""

    # Passive hits (vertex vs obstacle).
    p_mask: jax.Array  # bool [H]
    p_vidx: jax.Array  # i32 [H] global vertex index
    p_normal: jax.Array  # [H, 3]
    p_point: jax.Array  # [H, 3]
    # Dynamic hits (vertex vs deforming-face, self collision).
    d_mask: jax.Array  # bool [H]
    d_vidx: jax.Array  # i32 [H]
    d_face: jax.Array  # i32 [H, 3]
    d_barys: jax.Array  # [H, 3]
    d_normal: jax.Array  # [H, 3]
    # True if any fixed-capacity stage dropped a contact this detect
    # (hash-grid cell cap or HIT_CAP compaction, collision/dynamic.py) —
    # surfaced through the step into RuntimeData so a dropped contact is
    # never invisible ("no silent drops").
    overflow: jax.Array  # bool scalar
    # STATIC: the surface is every vertex in order (surf_inds == arange(N),
    # the default whenever collision objects exist, src/Collider.hpp:158).
    # The hit-row gathers/scatters (x[p_vidx], .at[p_vidx].add) are then
    # the identity and every C/C^T apply below becomes pure elementwise
    # work: no arbitrary-index gather in any penalty-CG iteration.
    dense: bool = False
    # STATIC: dynamic colliders are registered. When False, d_mask is
    # identically False and the dynamic-row terms (including the d_face
    # scatter, the one op `dense` cannot remove) are dead code — elide
    # them at trace time.
    may_dyn: bool = True

    @property
    def capacity(self) -> int:
        return self.p_mask.shape[0]

    def n_active(self):
        total = jnp.sum(self.p_mask.astype(jnp.int32)) + jnp.sum(self.d_mask.astype(jnp.int32))
        return total.astype(jnp.int32)

    def dedup(self) -> "Hits":
        """Drop dynamic rows on vertices that already have a passive row."""
        return dataclasses.replace(self, d_mask=self.d_mask & ~self.p_mask)


jax.tree_util.register_dataclass(
    Hits,
    data_fields=(
        "p_mask", "p_vidx", "p_normal", "p_point",
        "d_mask", "d_vidx", "d_face", "d_barys", "d_normal", "overflow",
    ),
    meta_fields=("dense", "may_dyn"),
)


def empty_hits(surf_inds, dtype, dense: bool = False,
               may_dyn: bool = True) -> Hits:
    h = surf_inds.shape[0]
    z3 = jnp.zeros((h, 3), dtype=dtype)
    return Hits(
        p_mask=jnp.zeros((h,), dtype=bool),
        p_vidx=surf_inds,
        p_normal=z3,
        p_point=z3,
        d_mask=jnp.zeros((h,), dtype=bool),
        d_vidx=surf_inds,
        d_face=jnp.zeros((h, 3), dtype=jnp.int32),
        d_barys=z3,
        d_normal=z3,
        overflow=jnp.asarray(False),
        dense=dense,
        may_dyn=may_dyn,
    )


# ---------------------------------------------------------------------------
# Matrix-free C / C^T / diag(C^T C)
# ---------------------------------------------------------------------------

def C_apply(hits: Hits, ck, x):
    """C x -> ([Hp], [Hd]) row values (masked rows are 0)."""
    xp = x if hits.dense else x[hits.p_vidx]  # [H, 3]
    rp = ck * jnp.sum(hits.p_normal * xp, axis=-1)
    rp = jnp.where(hits.p_mask, rp, 0.0)

    if not hits.may_dyn:
        return rp, jnp.zeros_like(rp)
    xv = x if hits.dense else x[hits.d_vidx]
    xf = x[hits.d_face]  # [H, 3, 3]
    face_pt = jnp.sum(hits.d_barys[..., None] * xf, axis=-2)
    rd = ck * jnp.sum(hits.d_normal * (xv - face_pt), axis=-1)
    rd = jnp.where(hits.d_mask, rd, 0.0)
    return rp, rd


def C_rhs(hits: Hits, ck):
    """c: passive rows ck * n.p, dynamic rows 0 (src/ConstraintSet.hpp:84,96)."""
    cp = ck * jnp.sum(hits.p_normal * hits.p_point, axis=-1)
    cp = jnp.where(hits.p_mask, cp, 0.0)
    cd = jnp.zeros_like(cp)
    return cp, cd


def Ct_apply(hits: Hits, ck, yp, yd, n_verts):
    """C^T [yp; yd] -> [N, 3]."""
    yp = jnp.where(hits.p_mask, yp, 0.0)
    p_part = (ck * yp)[..., None] * hits.p_normal
    if not hits.may_dyn:
        if hits.dense:
            return p_part
        out = jnp.zeros((n_verts, 3), dtype=hits.p_normal.dtype)
        return out.at[hits.p_vidx].add(p_part)
    yd = jnp.where(hits.d_mask, yd, 0.0)
    d_part = (ck * yd)[..., None] * hits.d_normal
    if hits.dense:
        out = p_part + d_part
    else:
        out = jnp.zeros((n_verts, 3), dtype=hits.p_normal.dtype)
        out = out.at[hits.p_vidx].add(p_part)
        out = out.at[hits.d_vidx].add(d_part)
    contrib_f = -(ck * yd)[..., None, None] * hits.d_barys[..., None] * hits.d_normal[..., None, :]
    out = out.at[hits.d_face.reshape(-1)].add(contrib_f.reshape(-1, 3))
    return out


def CtC_diag(hits: Hits, ck, n_verts, dtype):
    """diag(C^T C) per dof -> [N, 3] (for the GS penalty fold)."""
    ck2 = ck * ck
    coef_p = jnp.where(hits.p_mask[..., None], ck2 * hits.p_normal**2, 0.0)
    if hits.dense:
        out = coef_p.astype(dtype)
    else:
        out = jnp.zeros((n_verts, 3), dtype=dtype)
        out = out.at[hits.p_vidx].add(coef_p)
    if not hits.may_dyn:
        return out
    coef_v = jnp.where(hits.d_mask[..., None], ck2 * hits.d_normal**2, 0.0)
    if hits.dense:
        out = out + coef_v
    else:
        out = out.at[hits.d_vidx].add(coef_v)
    coef_f = jnp.where(
        hits.d_mask[..., None, None],
        ck2 * (hits.d_barys[..., None] * hits.d_normal[..., None, :]) ** 2,
        0.0,
    )
    out = out.at[hits.d_face.reshape(-1)].add(coef_f.reshape(-1, 3))
    return out


def CtC_apply(hits: Hits, ck, x):
    """(C^T C) x -> [N, 3] (matrix-free penalty apply)."""
    rp, rd = C_apply(hits, ck, x)
    return Ct_apply(hits, ck, rp, rd, x.shape[0])


def Ct_c(hits: Hits, ck, n_verts):
    """C^T c -> [N, 3] (rhs shift for the penalty fold)."""
    cp, cd = C_rhs(hits, ck)
    return Ct_apply(hits, ck, cp, cd, n_verts)
