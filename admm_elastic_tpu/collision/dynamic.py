"""Dynamic (self) collision: vertex vs deforming tet mesh.

Vectorized equivalent of TetMeshCollision (src/DynamicObject.hpp:33-119):
the reference rebuilds an AABB tree over the current tets every detect and
does point-in-tet + rest-pose nearest-triangle per query vertex. Here both
phases are dense batched tests (every query against every tet/face with
masks) — regular compute that XLA maps straight onto the vector units; a
Morton-grid broad phase can be layered on for very large meshes.

Pipeline per query vertex (identical semantics to the reference):
  1. point-in-tet test against the *current* pose, skipping tets that
     contain the query vertex itself (skip_vert_idx),
  2. map the hit point to the *rest* pose via barycentric coordinates,
  3. find the nearest *rest-pose* surface triangle (again skipping faces
     containing the query vertex),
  4. report the face (global indices), projection barycentrics, rest-pose
     face normal, and dx = -|proj - rest_x|.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


# Above this many collider tets the hash-grid broad phase replaces the
# dense masked all-pairs point-in-tet test (whose memory is O(H*T)).
# The crossover was measured on the previous accelerator; on the GPU it
# is not measured yet.
BROADPHASE_MIN_TETS = 32768
CELL_CAP = 24
# Max simultaneous penetrating vertices processed per collider per detect
# (the nearest-face stage is O(HIT_CAP * F)); exceeding it sets
# hit_overflow and defers the extras to the next ADMM iteration's detect.
HIT_CAP = 2048
_HASH = (73856093, 19349663, 83492791)  # Teschner et al. spatial hashing


@dataclasses.dataclass(frozen=True)
class TetMeshCollider:
    """Self-collision object for one tet mesh placed in the global DOF array."""

    tets: jax.Array  # i32 [T, 4] GLOBAL vertex indices
    rest_verts: jax.Array  # [V, 3] local rest positions
    faces: jax.Array  # i32 [F, 3] LOCAL surface face indices (rest winding)
    vert_offset: int  # static: global index of local vertex 0
    # Static per-cell candidate capacity for the hash-grid broad phase,
    # sized from the rest pose (2x max rest density, clamped to [8, 48]).
    cell_cap: int = CELL_CAP

    @property
    def n_tets(self) -> int:
        return self.tets.shape[0]


jax.tree_util.register_dataclass(
    TetMeshCollider, data_fields=("tets", "rest_verts", "faces"),
    meta_fields=("vert_offset", "cell_cap"),
)


def _rest_cell_cap(rest_verts: np.ndarray, tets: np.ndarray) -> int:
    """3x the max rest-pose tet-center count per grid cell, in [16, 64].

    The margin covers deformation densifying cells (e.g. a fold stacking
    two regions plus moderate compression); detect_dynamic reports
    broad_overflow when even this is exceeded."""
    x4 = rest_verts[tets]
    ext = (x4.max(axis=1) - x4.min(axis=1)).max()
    if ext <= 0:
        return CELL_CAP
    centers = x4.mean(axis=1)
    cells = np.floor((centers - centers.min(axis=0)) / ext).astype(np.int64)
    key = (cells[:, 0] * 73856093) ^ (cells[:, 1] * 19349663) ^ (cells[:, 2] * 83492791)
    _, counts = np.unique(key, return_counts=True)
    return int(np.clip(3 * counts.max(), 16, 64))


def make_tet_mesh_collider(rest_verts: np.ndarray, tets: np.ndarray, faces: np.ndarray,
                           vert_offset: int, dtype=np.float64) -> TetMeshCollider:
    rest_np = np.asarray(rest_verts, dtype=np.float64)
    tets_np = np.asarray(tets, dtype=np.int64)
    cap = _rest_cell_cap(rest_np, tets_np)
    return TetMeshCollider(
        cell_cap=cap,
        tets=jnp.asarray(np.asarray(tets, dtype=np.int64) + vert_offset, dtype=jnp.int32),
        rest_verts=jnp.asarray(rest_verts, dtype=dtype),
        faces=jnp.asarray(faces, dtype=jnp.int32),
        vert_offset=vert_offset,
    )


def _closest_point_triangle(p, a, b, c):
    """Batched closest point on triangle (Ericson). Shapes broadcast.

    Returns (closest [..,3], bary [..,3])."""
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = jnp.sum(ab * ap, -1)
    d2 = jnp.sum(ac * ap, -1)
    bp = p - b
    d3 = jnp.sum(ab * bp, -1)
    d4 = jnp.sum(ac * bp, -1)
    cp = p - c
    d5 = jnp.sum(ab * cp, -1)
    d6 = jnp.sum(ac * cp, -1)
    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    denom = jnp.where(jnp.abs(va + vb + vc) < 1e-30, 1.0, va + vb + vc)
    v = vb / denom
    w = vc / denom
    # Vertex regions.
    in_a = (d1 <= 0) & (d2 <= 0)
    in_b = (d3 >= 0) & (d4 <= d3)
    in_c = (d6 >= 0) & (d5 <= d6)
    # Edge regions.
    on_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    t_ab = d1 / jnp.where(jnp.abs(d1 - d3) < 1e-30, 1.0, d1 - d3)
    on_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    t_ac = d2 / jnp.where(jnp.abs(d2 - d6) < 1e-30, 1.0, d2 - d6)
    on_bc = (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0)
    t_bc = (d4 - d3) / jnp.where(jnp.abs((d4 - d3) + (d5 - d6)) < 1e-30, 1.0, (d4 - d3) + (d5 - d6))

    v = jnp.where(on_bc, 1.0 - t_bc, v)
    w = jnp.where(on_bc, t_bc, w)
    v = jnp.where(on_ac, 0.0, v)
    w = jnp.where(on_ac, jnp.clip(t_ac, 0, 1), w)
    v = jnp.where(on_ab, jnp.clip(t_ab, 0, 1), v)
    w = jnp.where(on_ab, 0.0, w)
    v = jnp.where(in_c, 0.0, v)
    w = jnp.where(in_c, 1.0, w)
    v = jnp.where(in_b, 1.0, v)
    w = jnp.where(in_b, 0.0, w)
    v = jnp.where(in_a, 0.0, v)
    w = jnp.where(in_a, 0.0, w)
    v = jnp.clip(v, 0.0, 1.0)
    w = jnp.clip(w, 0.0, jnp.maximum(1.0 - v, 0.0))
    closest = a + v[..., None] * ab + w[..., None] * ac
    bary = jnp.stack([1.0 - v - w, v, w], axis=-1)
    return closest, bary


# Broad-phase configuration: above this tet count, point-in-tet tests run
# only against hash-grid candidates instead of all T tets. CELL_CAP tets
# are kept per grid cell; a query checks its 3x3x3 cell neighborhood, so
# each vertex narrow-phases against <= 27*CELL_CAP candidates.
def _cell_keys(pts, origin, inv_cell):
    c = jnp.floor((pts - origin) * inv_cell).astype(jnp.int32)
    return (c[..., 0] * _HASH[0]) ^ (c[..., 1] * _HASH[1]) ^ (c[..., 2] * _HASH[2])


def _broad_phase_candidates(x4, query_pts, cap: int = CELL_CAP):
    """Hash-grid candidates: i32 [H, 27*CELL_CAP] tet ids (T = miss pad).

    Cell size = the largest tet AABB extent, so any tet containing a point
    has its *center* within one cell of that point — the 27-neighborhood
    is exhaustive. Cells holding more than CELL_CAP tet centers overflow
    (extra tets not candidates); overflow is detectable per query (second
    return value) so callers can assert coverage. CELL_CAP=24 covers a
    5-tets-per-cube grid folded onto itself ~2x.
    """
    t = x4.shape[0]
    centers = jnp.mean(x4, axis=1)  # [T,3]
    lo = jnp.min(x4, axis=(0, 1))
    ext = jnp.max(x4, axis=1) - jnp.min(x4, axis=1)  # [T,3]
    cell = jnp.maximum(jnp.max(ext), 1e-12)
    inv_cell = 1.0 / cell

    keys = _cell_keys(centers, lo, inv_cell)  # i32 [T]
    order = jnp.argsort(keys)
    keys_sorted = keys[order]

    qc = jnp.floor((query_pts - lo) * inv_cell).astype(jnp.int32)  # [H,3]
    offs = jnp.stack(
        jnp.meshgrid(*([jnp.arange(-1, 2)] * 3), indexing="ij"), axis=-1
    ).reshape(27, 3)
    nb = qc[:, None, :] + offs[None, :, :]  # [H,27,3]
    nb_keys = (nb[..., 0] * _HASH[0]) ^ (nb[..., 1] * _HASH[1]) ^ (nb[..., 2] * _HASH[2])
    start = jnp.searchsorted(keys_sorted, nb_keys.reshape(-1)).reshape(nb_keys.shape)
    sl = start[..., None] + jnp.arange(cap)  # [H,27,CAP]
    valid = sl < t
    sl_c = jnp.minimum(sl, t - 1)
    key_match = (keys_sorted[sl_c] == nb_keys[..., None]) & valid
    cand = jnp.where(key_match, order[sl_c], t)  # t = miss pad
    # Overflow: the slot one past the capacity window still matches the key.
    past = jnp.minimum(start + cap, t - 1)
    over = jnp.any((keys_sorted[past] == nb_keys) & (start + cap < t), axis=-1)
    return cand.reshape(query_pts.shape[0], -1), over  # [H, 27*CAP], [H]


def detect_dynamic(collider: TetMeshCollider, x, query_pts, query_vidx):
    """Detect self-collisions of query vertices against one tet mesh.

    Args:
      x: [N, 3] all current positions.
      query_pts: [H, 3] positions of the query (surface) vertices.
      query_vidx: i32 [H] their global indices.
    Returns dict(mask, face [H,3] global, barys [H,3], normal [H,3], dx [H]).

    For meshes above BROADPHASE_MIN_TETS the point-in-tet stage tests only
    hash-grid candidates (O(H * 27*CELL_CAP)) instead of every tet
    (O(H*T)); the winner is the lowest tet index containing the point in
    both paths, so results are identical where the cell capacity suffices.
    """
    from admm_elastic_tpu.ops.svd3 import det3, inv3

    tets = collider.tets  # [T,4] global
    t_total = tets.shape[0]
    x4 = x[tets]  # [T,4,3]
    e = jnp.stack([x4[:, 1] - x4[:, 0], x4[:, 2] - x4[:, 0], x4[:, 3] - x4[:, 0]], axis=-1)
    det = det3(e)
    safe = jnp.abs(det) > 1e-30
    e_safe = jnp.where(safe[:, None, None], e, jnp.eye(3, dtype=e.dtype))
    einv = inv3(e_safe)  # [T,3,3] (pure arithmetic; no LAPACK custom call)
    base = x4[:, 0]

    if t_total > BROADPHASE_MIN_TETS:
        cand, overflow = _broad_phase_candidates(x4, query_pts, collider.cell_cap)
        cand_c = jnp.minimum(cand, t_total - 1)
        real = cand < t_total
        d = query_pts[:, None, :] - base[cand_c]  # [H,C,3]
        b = jnp.einsum("hcij,hcj->hci", einv[cand_c], d,
                       precision=jax.lax.Precision.HIGHEST)
        b0 = 1.0 - jnp.sum(b, axis=-1)
        bary4 = jnp.concatenate([b0[..., None], b], axis=-1)  # [H,C,4]
        inside = jnp.all(bary4 >= 0.0, axis=-1) & safe[cand_c] & real
        own = jnp.any(tets[cand_c] == query_vidx[:, None, None], axis=-1)
        inside = inside & ~own
        hit_any = jnp.any(inside, axis=-1)
        # Lowest tet index among hits (matches the dense path's argmax).
        pick = jnp.min(jnp.where(inside, cand_c, t_total), axis=-1)
        hit_tet = jnp.minimum(pick, t_total - 1)
        slot = jnp.argmin(jnp.where(inside, cand_c, t_total), axis=-1)
        hit_bary = jnp.take_along_axis(bary4, slot[:, None, None], axis=1)[:, 0]
        broad_overflow = overflow
    else:
        d = query_pts[:, None, :] - base[None, :, :]  # [H,T,3]
        b = jnp.einsum("tij,htj->hti", einv, d,
                       precision=jax.lax.Precision.HIGHEST)  # [H,T,3]
        b0 = 1.0 - jnp.sum(b, axis=-1)
        bary4 = jnp.concatenate([b0[..., None], b], axis=-1)  # [H,T,4]
        inside = jnp.all(bary4 >= 0.0, axis=-1) & safe[None, :]

        # Skip tets containing the query vertex itself (skip_vert_idx,
        # src/DynamicObject.hpp:77).
        own = jnp.any(tets[None, :, :] == query_vidx[:, None, None], axis=-1)
        inside = inside & ~own

        hit_any = jnp.any(inside, axis=-1)  # [H]
        hit_tet = jnp.argmax(inside, axis=-1)  # [H]
        hit_bary = jnp.take_along_axis(bary4, hit_tet[:, None, None], axis=1)[:, 0]  # [H,4]
        broad_overflow = jnp.zeros_like(hit_any)

    # Map to rest pose (src/DynamicObject.hpp:85-99).
    local_tets = tets[hit_tet] - collider.vert_offset  # [H,4] local
    rest4 = collider.rest_verts[local_tets]  # [H,4,3]
    rest_x = jnp.sum(hit_bary[..., None] * rest4, axis=-2)  # [H,3]

    # Compact the (few) hit vertices before the O(Hc * F) nearest-face
    # stage: only penetrating vertices need a projection target, and hits
    # are bounded by the contact area, not the surface size. Capacity
    # HIT_CAP with overflow flagged (no silent drops). Stable sort keeps
    # the hit order, preserving dense-path results.
    h_total = query_pts.shape[0]
    hc = min(h_total, HIT_CAP)
    sel = jnp.argsort(~hit_any, stable=True)[:hc]  # hit indices first
    hit_overflow = jnp.sum(hit_any) > hc
    rest_x_c = rest_x[sel]
    local_q_c = (query_vidx - collider.vert_offset)[sel]

    # Nearest rest-pose surface triangle, skipping faces containing the
    # query vertex (local index).
    faces = collider.faces  # [F,3] local
    fa = collider.rest_verts[faces[:, 0]]
    fb = collider.rest_verts[faces[:, 1]]
    fc = collider.rest_verts[faces[:, 2]]
    closest, bary = _closest_point_triangle(
        rest_x_c[:, None, :], fa[None], fb[None], fc[None]
    )  # [Hc,F,3]
    dist = jnp.linalg.norm(closest - rest_x_c[:, None, :], axis=-1)  # [Hc,F]
    face_has_q = jnp.any(faces[None, :, :] == local_q_c[:, None, None], axis=-1)
    big = jnp.finfo(dist.dtype).max
    dist = jnp.where(face_has_q, big, dist)
    near_f_c = jnp.argmin(dist, axis=-1)  # [Hc]
    near_d_c = jnp.take_along_axis(dist, near_f_c[:, None], axis=1)[:, 0]
    near_bary_c = jnp.take_along_axis(bary, near_f_c[:, None, None], axis=1)[:, 0]

    # Scatter compacted results back to full [H] (unique sel indices).
    near_f = jnp.zeros((h_total,), near_f_c.dtype).at[sel].set(near_f_c)
    near_d = jnp.full((h_total,), big, near_d_c.dtype).at[sel].set(near_d_c)
    near_bary = jnp.zeros((h_total, 3), near_bary_c.dtype).at[sel].set(near_bary_c)
    # Vertices beyond capacity lose their hit this iteration (flagged).
    in_cap = jnp.zeros((h_total,), bool).at[sel].set(True)
    hit_any = hit_any & in_cap

    hit_faces = faces[near_f]  # [H,3] local
    n = jnp.cross(
        collider.rest_verts[hit_faces[:, 1]] - collider.rest_verts[hit_faces[:, 0]],
        collider.rest_verts[hit_faces[:, 2]] - collider.rest_verts[hit_faces[:, 0]],
    )
    n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-30)

    return dict(
        mask=hit_any,
        face=hit_faces + collider.vert_offset,
        barys=near_bary,
        normal=n,
        dx=jnp.where(hit_any, -near_d, big),
        # True where the query's cell neighborhood exceeded CELL_CAP (some
        # tets were not candidates) — no silent-drop accounting.
        broad_overflow=broad_overflow,
        hit_overflow=hit_overflow,
    )
