"""Passive collision obstacles as batched signed-distance evaluations.

Mirrors the reference obstacle set: analytic Floor and Sphere SDFs
(src/PassiveObject.hpp:32-64) and mesh obstacles. The reference's
PassiveMesh does BVH point-in-tet + nearest-triangle per query
(src/PassiveObject.hpp:67-107); two vectorized equivalents are provided:

- PassiveMeshExact — the reference's exact semantics with the BVH
  replaced by a fixed-capacity uniform-grid candidate table (exact
  nearest-surface-triangle projection; the inside test signs against the
  angle-weighted pseudonormal of the closest feature, with a global
  brute-force fallback whenever the candidate set cannot guarantee the
  closest feature). Trajectory parity with the reference binary: 2.1e-6
  over 40 steps (tests/test_parity.py::test_mesh_obstacle_exact_parity).
- PassiveMeshSDF — a precomputed voxel SDF with trilinear interpolation
  + analytic gradient (one gather + lerp per query); the throughput
  option, with an O(h) accuracy envelope measured in
  test_mesh_obstacle_sdf_accuracy.

All `signed_distance` methods are batched: x [..., 3] -> (dx [...],
point [..., 3], normal [..., 3]) with the reference payload convention:
dx < 0 means penetration, `point` is the surface projection target and
`normal` the outward contact normal.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class Floor:
    """y-plane floor (src/PassiveObject.hpp:32-45)."""

    y: jax.Array  # scalar

    def signed_distance(self, x):
        dx = x[..., 1] - self.y
        point = jnp.stack([x[..., 0], jnp.broadcast_to(self.y, x[..., 1].shape), x[..., 2]], axis=-1)
        # NOTE: constant broadcast, NOT zeros().at[..., 1].set(1.0) — one
        # accelerator compiler (not the GPU's) miscompiled that scatter-set
        # to all zeros when fused into a larger program (the floor
        # constraint rows vanished and bodies passed through the floor).
        normal = jnp.broadcast_to(jnp.asarray([0.0, 1.0, 0.0], x.dtype), x.shape)
        return dx, point, normal


jax.tree_util.register_dataclass(Floor, data_fields=("y",), meta_fields=())


@dataclasses.dataclass(frozen=True)
class Sphere:
    """Analytic sphere obstacle (src/PassiveObject.hpp:48-64)."""

    center: jax.Array  # [3]
    rad: jax.Array  # scalar

    def signed_distance(self, x):
        dir_ = x - self.center
        dist = jnp.linalg.norm(dir_, axis=-1)
        dx = dist - self.rad
        n = dir_ / jnp.maximum(dist, 1e-30)[..., None]
        point = self.center + n * self.rad
        return dx, point, n


jax.tree_util.register_dataclass(Sphere, data_fields=("center", "rad"), meta_fields=())


@dataclasses.dataclass(frozen=True)
class PassiveMeshSDF:
    """Voxel-grid SDF obstacle (vectorized replacement for PassiveMesh).

    Packed layout: ``vals4`` [Gx*Gy*Gz, 4] holds
    (sdf, d/dx, d/dy, d/dz) at every lattice node, node gradients baked by
    central differences host-side. A query is then ONE 8-row gather (the
    cube corners, constant flat offsets) + a trilinear blend of all four
    channels, instead of re-sampling the value grid 7 times (center + 6
    gradient offsets) = 56 corner gathers/query.
    The normal is the interpolated node gradient instead of the gradient
    of the interpolant — both are O(h) approximations of the true normal
    and sit inside the measured O(h) accuracy envelope
    (tests/test_parity.py::test_mesh_obstacle_sdf_accuracy).

    The projection point is x - dx * normal, payload convention as above.
    """

    vals4: jax.Array  # [Gx*Gy*Gz, 4] packed (value, grad xyz) per node
    # minv[b] = min over the 8 corners of the cube based at node b (+inf
    # where b cannot be a base). The trilinear value is a convex
    # combination of those corners, so interp(p) >= minv[base]: a cell
    # with minv >= 0 provably cannot produce a contact. This is the
    # TIGHTEST cell-level gate — cells graze-near the surface from
    # outside are excluded (a value-threshold gate like v0 < sqrt(3)h is
    # ~2 cells looser on both sides and overflowed real capacities).
    minv: jax.Array  # [Gx*Gy*Gz]
    origin: jax.Array  # [3]
    h: jax.Array  # scalar spacing
    dims: tuple  # (Gx, Gy, Gz) static
    # Near-lane compaction capacity (static; 0 = dense), mirroring
    # PassiveMeshExact.near_lanes: tier 1 gathers ONE minv scalar (4 B)
    # per lane instead of the 8 [.,4] corner rows (128 B) and only
    # compacted lanes pay the blend. Penetrating queries stay bit-exact
    # vs dense; non-penetrating ones report no-hit (contact consumers
    # only read dx < 0). Overflow (more near lanes than capacity)
    # degrades extras to no-hit and surfaces via detect_passive ->
    # RuntimeData.collision_overflow.
    near_lanes: int = 0

    def signed_distance(self, x):
        dx, point, normal, _ = self.signed_distance_with_overflow(x)
        return dx, point, normal

    def signed_distance_with_overflow(self, x):
        dtype = x.dtype
        lead = x.shape[:-1]
        p = x.reshape(-1, 3)
        gx, gy, gz = self.dims
        shape = jnp.asarray((gx, gy, gz), dtype=dtype)
        u = (p - self.origin.astype(dtype)) / self.h.astype(dtype)
        u = jnp.clip(u, 0.0, shape - 1.000001)
        i0 = jnp.floor(u).astype(jnp.int32)
        f = u - i0.astype(dtype)
        base = (i0[..., 0] * gy + i0[..., 1]) * gz + i0[..., 2]

        k_near = int(self.near_lanes)
        if 0 < k_near < p.shape[0]:
            near = self.minv[base] < 0  # [V] — one 4 B scalar per lane
            _, sel = jax.lax.top_k(near.astype(jnp.int32), k_near)
            sel_mask = near[sel]
            dx_k, n_k = self._blend(base[sel], f[sel], dtype)
            big = jnp.asarray(1e30, dtype)
            dx = jnp.full((p.shape[0],), big, dtype)
            dx = dx.at[sel].set(jnp.where(sel_mask, dx_k, big))
            n = jnp.zeros_like(p).at[sel].set(
                jnp.where(sel_mask[:, None], n_k, 0.0))
            overflow = jnp.sum(near.astype(jnp.int32)) > k_near
        else:
            dx, n = self._blend(base, f, dtype)
            overflow = jnp.asarray(False)
        point = p - dx[..., None] * n
        # Far compacted lanes: dx = 1e30 makes `point` garbage; zero it so
        # the payload stays finite (it is masked out downstream anyway).
        point = jnp.where((dx < 1e29)[..., None], point, 0.0)
        return (dx.reshape(lead), point.reshape(lead + (3,)),
                n.reshape(lead + (3,)), overflow)

    def _blend(self, base, f, dtype):
        """Trilinear blend of the packed (value, gradient) rows at the 8
        cube corners of each lane: base [V] flat node ids, f [V,3]
        in-cell fractions. Returns (dx [V], unit normal [V,3])."""
        gx, gy, gz = self.dims
        # Constant corner offsets, dk fastest — order must match `w` below.
        offs = jnp.asarray(
            [(di * gy + dj) * gz + dk
             for di in (0, 1) for dj in (0, 1) for dk in (0, 1)],
            dtype=jnp.int32)
        rows = self.vals4[base[..., None] + offs].astype(dtype)  # [..., 8, 4]
        wx = jnp.stack([1.0 - f[..., 0], f[..., 0]], axis=-1)
        wy = jnp.stack([1.0 - f[..., 1], f[..., 1]], axis=-1)
        wz = jnp.stack([1.0 - f[..., 2], f[..., 2]], axis=-1)
        w = jnp.stack(
            [wx[..., di] * wy[..., dj] * wz[..., dk]
             for di in (0, 1) for dj in (0, 1) for dk in (0, 1)],
            axis=-1)  # [..., 8]
        # Elementwise multiply-add, NOT einsum/matmul: a default-precision
        # f32 product may run in reduced precision (TF32 on the GPU) and
        # this blend is contact geometry.
        vals = jnp.sum(w[..., None] * rows, axis=-2)  # [..., 4]
        dx = vals[..., 0]
        n = vals[..., 1:]
        n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-30)
        return dx, n

    @staticmethod
    def from_grid(grid: np.ndarray, origin, h, near_lanes: int = 0):
        """Pack a raw [Gx, Gy, Gz] value grid: bake node gradients by
        central differences (one-sided at the boundary) into vals4."""
        grid = np.asarray(grid, dtype=np.float64)
        h = float(h)
        grad = np.stack(np.gradient(grid, h), axis=-1)  # [Gx, Gy, Gz, 3]
        vals4 = np.concatenate([grid[..., None], grad], axis=-1)
        # Per-base-node cube minimum (see minv field note). Bases on the
        # +1 border are never indexed (u is clipped to dims-1.000001) —
        # leave them +inf.
        minv = np.full(grid.shape, np.inf)
        minv[:-1, :-1, :-1] = np.minimum.reduce([
            grid[di:di + grid.shape[0] - 1,
                 dj:dj + grid.shape[1] - 1,
                 dk:dk + grid.shape[2] - 1]
            for di in (0, 1) for dj in (0, 1) for dk in (0, 1)])
        return PassiveMeshSDF(
            vals4=jnp.asarray(vals4.reshape(-1, 4)),
            minv=jnp.asarray(minv.reshape(-1)),
            origin=jnp.asarray(np.asarray(origin, dtype=np.float64)),
            h=jnp.asarray(h), dims=tuple(int(d) for d in grid.shape),
            near_lanes=int(near_lanes),
        )

    @staticmethod
    def from_tet_mesh(verts: np.ndarray, tets: np.ndarray, resolution: int = 48, pad: float = 0.1,
                      near_lanes: int = 0):
        """Build a voxel SDF from a closed tet mesh (host-side, numpy).

        Inside test = point-in-any-tet; magnitude = distance to the surface
        triangle soup. O(G^3 * T) brute force — init-time only.
        """
        from admm_elastic_tpu.geometry.mesh import surface_faces_from_tets

        verts = np.asarray(verts, dtype=np.float64)
        tets = np.asarray(tets, dtype=np.int64)
        lo = verts.min(axis=0) - pad
        hi = verts.max(axis=0) + pad
        h = float((hi - lo).max()) / (resolution - 1)
        dims = np.maximum(((hi - lo) / h).astype(int) + 2, 2)
        axes = [lo[i] + np.arange(dims[i]) * h for i in range(3)]
        pts = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, 3)

        inside = _points_in_tets_np(pts, verts, tets)
        faces = surface_faces_from_tets(tets)
        dist = _point_tri_distance_np(pts, verts, faces)
        sdf = np.where(inside, -dist, dist).reshape(tuple(dims))
        return PassiveMeshSDF.from_grid(sdf, lo, h, near_lanes=near_lanes)


jax.tree_util.register_dataclass(
    PassiveMeshSDF, data_fields=("vals4", "minv", "origin", "h"),
    meta_fields=("dims", "near_lanes"),
)


@dataclasses.dataclass(frozen=True)
class PassiveMeshExact:
    """Exact mesh-obstacle narrow phase (reference PassiveMesh semantics).

    The reference resolves mesh obstacles with a BVH point-in-tet inside
    test plus nearest-surface-triangle projection per query, signing with
    the raw face normal (src/PassiveObject.hpp:67-107, :85-91 projection,
    :84-88 inside test). Trees don't vectorize; the equivalent here is a
    uniform grid of FIXED-CAPACITY candidate lists (masked, so shapes
    never depend on data):

    - projection: exact Ericson closest-point over the cell's candidate
      surface triangles (every triangle within ``capture_cells`` grid
      cells), nearest feature classified from the barycentric clamp, and
      the outward normal taken from the angle-weighted pseudonormal of
      that feature (Baerentzen & Aanaes 2005) — well-defined on faces,
      edges and vertices alike, unlike the raw face normal.
    - inside test: sign of (p - closest)·pseudonormal at the closest
      feature. This is the Baerentzen-equivalent of the reference's BVH
      point-in-tet sign, NOT its method — it is exact for closed meshes
      whenever the closest feature is the TRUE global closest, which the
      capture-radius guarantee (below) plus the fallback enforce.

    Accuracy envelope: the candidate table provably contains the global
    closest feature whenever the query's distance to the surface is at
    most the capture radius (``capture_cells * h``, default 2 cells) —
    faces are bucketed by per-axis AABB inflation, so Euclidean distance
    <= capture implies capture. Lanes whose nearest CANDIDATE lies beyond
    that radius (or that have no candidate at all) cannot rely on the
    table: on non-convex meshes a spurious diagonal-band candidate could
    mis-sign a deep interior point. Those lanes — the regime where the
    reference's BVH still finds the nearest triangle at ANY depth
    (src/PassiveObject.hpp:85-91) — take the DEEP FALLBACK: they are
    compacted to a fixed-capacity set of ``fallback_lanes`` rows and
    projected by a brute-force argmin over ALL surface triangles, so the
    sign and restoring constraint stay exact at any depth. The fallback
    runs under a lax.cond, so steady shallow contact never pays its
    O(K*F) cost; if more than ``fallback_lanes`` lanes simultaneously
    need it, the extras report no-hit for the step and the overflow is
    surfaced through RuntimeData.collision_overflow (raise the capacity
    via ``from_tet_mesh`` for pathological scenes). Use PassiveMeshSDF
    when throughput matters more than sharp features (the SDF is one
    gather per query; this is ~K_f gathered candidate rows per query).
    """

    # Packed per-triangle rows: gathers are the narrow phase's cost, so
    # the candidate loop gathers ONE [F,3,3] row per
    # candidate (corners a,b,c) instead of three [F,3] tables, and ONE
    # [F,7,3] row per *selected* face for the pseudonormals
    # (face, vert a/b/c, edge ab/bc/ca) instead of three.
    tri_abc: jax.Array  # [F, 3, 3] corners a, b, c
    nrm: jax.Array  # [F, 7, 3] pseudonormals: nf, nv(a,b,c), ne(ab,bc,ca)
    face_table: jax.Array  # [C, Kf] int32
    face_count: jax.Array  # [C] int32
    # tet_count is the only piece of the tet tables kept on device: it is
    # the tier-1 occupancy gate and the fallback trigger. The [T,4,3]
    # tet_pack / [C,Kt] tet_table of an earlier point-in-tet scan are
    # not baked (~30 MB at 512k tets through every jitted step).
    # Stored int8 0/1: nothing ever reads the magnitude, only > 0, and
    # the tier-1 gate gathers one row per query lane over ALL V lanes
    # every detection — int32 would be 4x the gathered bytes.
    tet_count: jax.Array  # [C] int8 occupancy (0/1)
    origin: jax.Array  # [3]
    h: jax.Array  # scalar cell size
    dims: tuple  # (Gx, Gy, Gz) static
    # Guaranteed-exact candidate radius in cells (static, bake-time):
    # the face table contains the global closest feature for any query
    # within capture_cells * h of the surface. _narrow routes lanes whose
    # nearest candidate exceeds this radius to the deep fallback.
    capture_cells: float = 2.0
    fallback_lanes: int = 128  # deep-penetration fallback capacity (static)
    # Near-lane compaction capacity (static; 0 = dense). The narrow phase
    # gathers ~Kf*36 B of candidate-triangle rows per query lane, so at
    # scale its cost is gathered bytes. Most query lanes are
    # nowhere near the obstacle: with near_lanes=K, a cheap tier-1 pass
    # (ONE int gather/lane: the cell's tet-candidate count) masks the
    # lanes that could possibly be penetrating — a point inside a tet
    # always lies in a cell that tet's AABB overlaps, so tet_count == 0
    # proves dx > 0 — compacts up to K of them with top_k, and only those
    # pay the candidate gathers. Every PENETRATING query stays exact
    # (same dx/point/normal as dense, any depth incl. the fallback);
    # non-penetrating queries report no-hit instead of their positive
    # distance, which contact consumers never read (hit = dx < 0, and
    # payload-min across obstacles only ever selects negative dx). If
    # more than K lanes are simultaneously near, the extras report no-hit
    # for that iteration and the overflow is surfaced through
    # detect_passive -> RuntimeData.collision_overflow (same policy as
    # the dynamic-hit caps: never a wrong projection, never a silent
    # drop).
    near_lanes: int = 0

    def _closest_feature(self, p, fids, fmask):
        """Exact closest point + pseudonormal over candidate triangles.

        p [V, 3]; fids [V, K] rows into the triangle soup; fmask [V, K].
        Returns (dist [V], closest [V,3], normal [V,3], any_face [V]).
        """
        abc = self.tri_abc[fids].astype(p.dtype)  # [V, K, 3, 3] — one gather
        return self._closest_over(p, abc, fmask, fids=fids)

    def _closest_over(self, p, abc, fmask, fids=None):
        """Core closest-feature kernel over given candidate corners.

        abc [V, K, 3, 3]; fids maps the K axis to triangle-soup rows
        (None = the K axis IS the soup row order — the fallback's
        broadcast full-soup form, which avoids the [V, K, 3, 3] gather
        entirely: the corners stream as a broadcast).
        """
        dtype = p.dtype
        big = jnp.asarray(1e30, dtype)
        a, b, c = abc[..., 0, :], abc[..., 1, :], abc[..., 2, :]
        closest, _, _ = _pt_tri_closest(p[:, None, :], a, b, c)
        d2 = jnp.sum((p[:, None, :] - closest) ** 2, axis=-1)
        d2 = jnp.where(fmask, d2, big)
        j = jnp.argmin(d2, axis=1)  # [V]
        take1 = lambda arr: jnp.take_along_axis(arr, j[:, None], axis=1)[:, 0]
        dist = jnp.sqrt(jnp.maximum(take1(d2), 0.0))
        any_face = jnp.any(fmask, axis=1)
        # Selected-face recompute: gather ONE [3,3] corner row per lane
        # and redo the closest point on that single triangle. Bit-
        # identical to extracting row j of pass 1 (_pt_tri_closest is
        # elementwise-deterministic on the same values), but it leaves
        # the wide [V, K, ...] pass-1 tensors with a SINGLE consumer (the
        # d2 reduction): extracting cl/v/w from them made XLA replay the
        # whole Kf-wide candidate gather a second time — obstacle_lab2
        # measured that replay at ~3.5 ms/call of the 8.5 ms narrow
        # phase at the 500k matrix geometry.
        fid_s = j if fids is None else take1(fids)
        abc_s = self.tri_abc[fid_s].astype(dtype)  # [V, 3, 3]
        cl, v_s, w_s = _pt_tri_closest(
            p, abc_s[:, 0, :], abc_s[:, 1, :], abc_s[:, 2, :])

        # Outward normal: angle-weighted pseudonormal of the closest
        # feature. The feature REGION is classified first from the
        # barycentric clamp and only that one [3] row is gathered
        # (nrm flat row fid*7 + region) — the r4 form gathered all 7 rows
        # per lane (84 B) and selected afterwards, which obstacle_lab2
        # measured at 2.3 ms/call at the 500k matrix geometry (~17% of
        # the whole narrow phase) against 0.15 ms for the one-row form.
        fid_s = j if fids is None else take1(fids)
        eps = jnp.asarray(1e-5, dtype)
        u_s = 1.0 - v_s - w_s
        # Region codes follow the nrm row layout: 0 face, 1-3 vertex
        # a/b/c, 4-6 edge ab/bc/ca. Same conditions, same override order
        # as the r4 vector where-chain — bit-identical selection.
        idx = jnp.zeros(j.shape, jnp.int32)
        idx = jnp.where(u_s <= eps, 5, idx)  # edge bc
        idx = jnp.where(v_s <= eps, 6, idx)  # edge ca
        idx = jnp.where(w_s <= eps, 4, idx)  # edge ab
        idx = jnp.where(w_s >= 1.0 - eps, 3, idx)  # vertex c
        idx = jnp.where(v_s >= 1.0 - eps, 2, idx)  # vertex b
        idx = jnp.where((v_s <= eps) & (w_s <= eps), 1, idx)  # vertex a
        n = self.nrm.reshape(-1, 3)[fid_s * 7 + idx].astype(dtype)  # [V, 3]
        n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-30)
        return dist, cl, n, any_face

    def signed_distance(self, x):
        dx, point, normal, _ = self.signed_distance_with_overflow(x)
        return dx, point, normal

    def signed_distance_with_overflow(self, x):
        """signed_distance plus a bool overflow scalar (True iff the
        near-lane compaction dropped lanes this call; always False in the
        dense near_lanes=0 mode). detect_passive picks this method up and
        routes the flag into RuntimeData.collision_overflow."""
        dtype = x.dtype
        lead = x.shape[:-1]
        p = x.reshape(-1, 3)
        big = jnp.asarray(1e30, dtype)

        dims = jnp.asarray(self.dims, dtype=jnp.int32)
        u = (p - self.origin.astype(dtype)) / self.h.astype(dtype)
        ci = jnp.floor(u).astype(jnp.int32)
        in_grid = jnp.all((ci >= 0) & (ci < dims), axis=-1)
        cic = jnp.clip(ci, 0, dims - 1)
        cid = (cic[:, 0] * dims[1] + cic[:, 1]) * dims[2] + cic[:, 2]

        k_near = int(self.near_lanes)
        if 0 < k_near < p.shape[0]:
            # Tier 1: ONE int gather/lane. A penetrating point lies inside
            # some tet, and a point inside a tet always sits in a cell that
            # tet's AABB overlaps — so tet_count == 0 proves dx > 0 and the
            # lane can never contribute a contact (Collider only consumes
            # dx < 0 hits; payload-min across obstacles also only ever
            # selects negative dx). Lanes in the positive-distance capture
            # shell are therefore skipped too: compacted mode reports
            # no-hit (dx = big) for every non-penetrating query instead of
            # its positive distance. All penetrating queries stay exact.
            near = in_grid & (self.tet_count[cid] > 0)
            _, sel = jax.lax.top_k(near.astype(jnp.int32), k_near)
            sel_mask = near[sel]
            dx_k, cl_k, n_k, fb_ovf = self._narrow(
                p[sel], cid[sel], sel_mask, dtype, big)
            dx = jnp.full((p.shape[0],), big, dtype)
            dx = dx.at[sel].set(jnp.where(sel_mask, dx_k, big))
            cl = jnp.zeros_like(p).at[sel].set(
                jnp.where(sel_mask[:, None], cl_k, 0.0))
            n = jnp.zeros_like(p).at[sel].set(
                jnp.where(sel_mask[:, None], n_k, 0.0))
            overflow = (jnp.sum(near.astype(jnp.int32)) > k_near) | fb_ovf
        else:
            dx, cl, n, fb_ovf = self._narrow(p, cid, in_grid, dtype, big)
            overflow = fb_ovf
        return (dx.reshape(lead), cl.reshape(lead + (3,)),
                n.reshape(lead + (3,)), overflow)

    def _narrow(self, p, cid, valid, dtype, big):
        """Exact narrow phase over [V] query lanes.

        Returns (dx, closest, normal, fb_overflow); ``valid`` masks lanes
        allowed to report candidates (in-grid and, under compaction,
        actually selected). fb_overflow is True iff more lanes needed the
        deep fallback than ``fallback_lanes`` could serve (the extras
        report no-hit — never a wrong sign, never a silent drop)."""
        in_grid = valid
        # Narrow phase: exact closest point over the cell's candidate tris.
        kf = self.face_table.shape[1]
        fids = self.face_table[cid].astype(jnp.int32)  # [V, Kf]
        fmask = (jnp.arange(kf, dtype=jnp.int32)[None, :] < self.face_count[cid][:, None])
        fmask = fmask & in_grid[:, None]
        dist, cl, n, any_face = self._closest_feature(p, fids, fmask)

        # Inside test (r4): sign of (p - closest)·pseudonormal at the
        # closest feature — exact for closed meshes at the TRUE closest
        # feature (Baerentzen & Aanaes 2005; the Baerentzen-EQUIVALENT of
        # the reference's inside test, which signs via BVH point-in-tet
        # and projects with the raw face normal,
        # src/PassiveObject.hpp:84-91) and free, since cl/n are already
        # in hand. This replaced a per-lane point-in-tet scan over the
        # cell's candidate tets: Kt tet-pack rows (40 x 48 B = 1.9 KB
        # per lane on the block slab) were ~6x the gathered bytes of the
        # whole face side, and the tet
        # GEOMETRY added nothing — the sign only needs the TRUE closest
        # feature, which the capture guarantee (<= capture radius) or
        # the fallback (beyond it) supplies. The tet tables survive only
        # as the tier-1 occupancy gate (tet_count, one 4 B scalar/lane).

        # Deep fallback (reference src/PassiveObject.hpp:85-91 finds the
        # nearest triangle at ANY depth). Two trigger classes, both in
        # tet-occupied cells (a point inside a tet always lies in a cell
        # that tet's AABB overlaps, so near_tet=False proves outside):
        #  (a) NO candidate face — provably deeper than the capture
        #      radius (every outside lane in a marked cell is within
        #      ~sqrt(3)h of the surface, well inside 2h face capture);
        #  (b) nearest CANDIDATE beyond the capture radius — the table
        #      only guarantees the global closest feature within
        #      capture_cells*h (per-axis AABB inflation), so a deeper
        #      lane can see ONLY a spurious diagonal-band candidate and
        #      signing against it can misclassify an inside point as
        #      outside on non-convex meshes. (Outside lanes in marked
        #      cells are within sqrt(3)h < capture, so (b) only fires on
        #      genuinely deep interior lanes — steady shallow contact
        #      never pays the fallback.)
        # Flagged lanes are compacted to `fallback_lanes` rows and
        # projected by brute-force argmin over ALL surface triangles, so
        # sign and projection stay exact at any depth. The fallback runs
        # UNCONDITIONALLY (keep() masks it to a no-op when no lane needs
        # it): its corners arrive as a broadcast of the whole soup — no
        # gather — so the whole pass is ~[k_fb, F] streamed elementwise work.
        # The r4 form wrapped it in lax.cond "so shallow contact never
        # pays it", but obstacle_lab2 measured the cond-wrapped block at
        # 5.9 ms/call UNTAKEN at the 500k matrix geometry (~2.4 ms the
        # cond itself — XLA pays for the gather-based branch either way
        # — and ~3.5 ms the pass-1 replay fixed in _closest_over). The
        # unconditional broadcast form is flat in fallback_lanes:
        # 8.50 ms at k_fb=0 vs 8.59 at 128 and 8.85 at 512 (lab2c).
        near_tet = self.tet_count[cid] > 0
        capture = (jnp.asarray(self.capture_cells, dtype)
                   * self.h.astype(dtype))
        need_fb = in_grid & near_tet & (~any_face | (dist > capture))
        unresolved = need_fb
        k_fb = min(int(self.fallback_lanes), p.shape[0])
        n_tris = self.tri_abc.shape[0]
        if k_fb > 0 and n_tris > 0:
            _, sel = jax.lax.top_k(need_fb.astype(jnp.int32), k_fb)
            sel_mask = need_fb[sel]  # [K]
            abc_all = jnp.broadcast_to(
                self.tri_abc.astype(dtype)[None], (k_fb, n_tris, 3, 3))
            dist_f, cl_f, n_f, any_f = self._closest_over(
                p[sel], abc_all,
                jnp.broadcast_to(sel_mask[:, None], (k_fb, n_tris)))
            keep = lambda new, old, m: jnp.where(m, new, old)
            dist = dist.at[sel].set(keep(dist_f, dist[sel], sel_mask))
            cl = cl.at[sel].set(keep(cl_f, cl[sel], sel_mask[:, None]))
            n = n.at[sel].set(keep(n_f, n[sel], sel_mask[:, None]))
            any_face = any_face.at[sel].set(
                keep(any_f, any_face[sel], sel_mask))
            unresolved = unresolved.at[sel].set(
                jnp.where(sel_mask, False, unresolved[sel]))

        # Lanes the fallback could not serve (capacity overflow, or a
        # degenerate zero-triangle mesh) have no guaranteed-exact answer:
        # demote them to no-hit and surface the overflow.
        fb_overflow = jnp.any(unresolved)
        any_face = any_face & ~unresolved

        # Sign AFTER the fallback so deep lanes sign against the global
        # closest feature. The & near_tet gate is an outside PROOF: an
        # inside point always sits in a tet-marked cell, so unmarked-cell
        # lanes are outside no matter what a spurious far candidate's
        # pseudonormal says — this kills phantom hits beyond the capture
        # radius (the mirror image of the deep-band mis-sign above).
        inside = (jnp.sum((p - cl) * n, axis=-1) < 0) & any_face & near_tet
        sgn = jnp.where(inside, -1.0, 1.0).astype(dtype)
        dx = jnp.where(any_face, sgn * dist, big)
        return dx, cl, n, fb_overflow

    @staticmethod
    def from_tet_mesh(verts: np.ndarray, tets: np.ndarray, cells: int = 32,
                      capture_cells: float = 2.0, fallback_lanes: int = 128,
                      near_lanes: int = 0):
        """Bake the candidate grid from a closed tet mesh (host, numpy).

        ``cells`` grid cells along the longest AABB axis; every cell lists
        the surface triangles within ``capture_cells * h`` of it and the
        tets overlapping it. Init-time only; tables are fixed-capacity.
        """
        verts = np.asarray(verts, dtype=np.float64)
        tets = np.asarray(tets, dtype=np.int64).copy()
        # Normalize tet orientation so extracted faces wind outward.
        x4 = verts[tets]
        vols = np.linalg.det(
            np.stack([x4[:, 1] - x4[:, 0], x4[:, 2] - x4[:, 0], x4[:, 3] - x4[:, 0]], axis=-1)
        )
        neg = vols < 0
        tets[neg] = tets[neg][:, [1, 0, 2, 3]]

        from admm_elastic_tpu.geometry.mesh import surface_faces_from_tets

        faces = surface_faces_from_tets(tets)
        a, b, c = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
        raw = np.cross(b - a, c - a)
        nf = raw / np.maximum(np.linalg.norm(raw, axis=-1, keepdims=True), 1e-300)

        # Angle-weighted vertex pseudonormals.
        acc = np.zeros_like(verts)
        corners = [(0, 1, 2), (1, 2, 0), (2, 0, 1)]
        for k, (i0, i1, i2) in enumerate(corners):
            e1 = verts[faces[:, i1]] - verts[faces[:, i0]]
            e2 = verts[faces[:, i2]] - verts[faces[:, i0]]
            cosang = (e1 * e2).sum(-1) / np.maximum(
                np.linalg.norm(e1, axis=-1) * np.linalg.norm(e2, axis=-1), 1e-300)
            ang = np.arccos(np.clip(cosang, -1.0, 1.0))
            np.add.at(acc, faces[:, i0], ang[:, None] * nf)
        vn = acc / np.maximum(np.linalg.norm(acc, axis=-1, keepdims=True), 1e-300)
        n_vert = vn[faces]  # [F, 3, 3]

        # Edge pseudonormals: sum of the two adjacent face normals.
        edges = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
        ekey = np.sort(edges, axis=1)
        uniq, inv = np.unique(ekey, axis=0, return_inverse=True)
        eacc = np.zeros((len(uniq), 3))
        np.add.at(eacc, inv, np.tile(nf, (3, 1)))
        en = eacc / np.maximum(np.linalg.norm(eacc, axis=-1, keepdims=True), 1e-300)
        n_edge = en[inv].reshape(3, len(faces), 3).transpose(1, 0, 2)  # ab, bc, ca

        # Grid.
        ext = verts.max(axis=0) - verts.min(axis=0)
        h = float(ext.max()) / cells
        capture = capture_cells * h
        lo = verts.min(axis=0) - capture - 0.5 * h
        hi = verts.max(axis=0) + capture + 0.5 * h
        dims = tuple(int(d) for d in np.ceil((hi - lo) / h).astype(int) + 1)
        ncell = dims[0] * dims[1] * dims[2]

        def cell_ranges(lo_pts, hi_pts, inflate):
            c0 = np.floor((lo_pts - inflate - lo) / h).astype(int)
            c1 = np.floor((hi_pts + inflate - lo) / h).astype(int)
            c0 = np.clip(c0, 0, np.asarray(dims) - 1)
            c1 = np.clip(c1, 0, np.asarray(dims) - 1)
            return c0, c1

        def build_table(lo_pts, hi_pts, inflate):
            c0, c1 = cell_ranges(lo_pts, hi_pts, inflate)
            buckets = [[] for _ in range(ncell)]
            for idx in range(len(lo_pts)):
                for ix in range(c0[idx, 0], c1[idx, 0] + 1):
                    for iy in range(c0[idx, 1], c1[idx, 1] + 1):
                        for iz in range(c0[idx, 2], c1[idx, 2] + 1):
                            buckets[(ix * dims[1] + iy) * dims[2] + iz].append(idx)
            cap = max(1, max(len(bk) for bk in buckets))
            table = np.zeros((ncell, cap), dtype=np.int32)
            count = np.zeros((ncell,), dtype=np.int32)
            for ci_, bk in enumerate(buckets):
                count[ci_] = len(bk)
                table[ci_, : len(bk)] = bk
            return table, count

        tri_pts = verts[faces]  # [F, 3, 3]
        face_table, face_count = build_table(
            tri_pts.min(axis=1), tri_pts.max(axis=1), capture)
        x4 = verts[tets]
        # Only the per-cell tet OCCUPANCY survives on device (tier-1 gate
        # + fallback trigger); the candidate ids themselves are dead
        # since the pseudonormal-sign rewrite. int8 0/1 — the gate only
        # tests > 0 and gathers one row per lane over ALL V lanes.
        _, tet_count = build_table(x4.min(axis=1), x4.max(axis=1), 0.0)
        tet_count = (tet_count > 0).astype(np.int8)
        # Candidate ids: int16 when the soup fits (it almost always
        # does), halving the [C, Kf] per-lane id-gather bytes; indices
        # are widened after the gather.
        if len(faces) < 32768:
            face_table = face_table.astype(np.int16)

        jarr = lambda arr: jnp.asarray(np.asarray(arr, dtype=np.float64))
        return PassiveMeshExact(
            tri_abc=jarr(np.stack([a, b, c], axis=1)),
            nrm=jarr(np.concatenate(
                [nf[:, None, :], n_vert, n_edge], axis=1)),
            face_table=jnp.asarray(face_table), face_count=jnp.asarray(face_count),
            tet_count=jnp.asarray(tet_count),
            origin=jarr(lo), h=jnp.asarray(float(h)), dims=dims,
            capture_cells=float(capture_cells),
            fallback_lanes=int(fallback_lanes), near_lanes=int(near_lanes),
        )


jax.tree_util.register_dataclass(
    PassiveMeshExact,
    data_fields=(
        "tri_abc", "nrm",
        "face_table", "face_count",
        "tet_count", "origin", "h",
    ),
    meta_fields=("dims", "capture_cells", "fallback_lanes", "near_lanes"),
)


def _pt_tri_closest(p, a, b, c):
    """Ericson closest point on triangle, batched jnp.

    Returns (closest, v, w) with closest = a + v*(b-a) + w*(c-a); mirrors
    the numpy `_pt_tri_np` region logic (shared semantics, jnp types).
    """
    tiny = 1e-30
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = (ab * ap).sum(-1)
    d2 = (ac * ap).sum(-1)
    bp = p - b
    d3 = (ab * bp).sum(-1)
    d4 = (ac * bp).sum(-1)
    cp = p - c
    d5 = (ab * cp).sum(-1)
    d6 = (ac * cp).sum(-1)
    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    denom = jnp.maximum(va + vb + vc, tiny)
    v = jnp.clip(vb / denom, 0.0, 1.0)
    w = jnp.clip(vc / denom, 0.0, 1.0)
    on_a = (d1 <= 0) & (d2 <= 0)
    v = jnp.where(on_a, 0.0, v)
    w = jnp.where(on_a, 0.0, w)
    on_b = (d3 >= 0) & (d4 <= d3)
    v = jnp.where(on_b, 1.0, v)
    w = jnp.where(on_b, 0.0, w)
    on_c = (d6 >= 0) & (d5 <= d6)
    v = jnp.where(on_c, 0.0, v)
    w = jnp.where(on_c, 1.0, w)
    e_ab = jnp.clip(d1 / jnp.maximum(d1 - d3, tiny), 0.0, 1.0)
    on_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    v = jnp.where(on_ab, e_ab, v)
    w = jnp.where(on_ab, 0.0, w)
    e_ac = jnp.clip(d2 / jnp.maximum(d2 - d6, tiny), 0.0, 1.0)
    on_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    v = jnp.where(on_ac, 0.0, v)
    w = jnp.where(on_ac, e_ac, w)
    e_bc = jnp.clip((d4 - d3) / jnp.maximum((d4 - d3) + (d5 - d6), tiny), 0.0, 1.0)
    on_bc = (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0)
    v = jnp.where(on_bc, 1.0 - e_bc, v)
    w = jnp.where(on_bc, e_bc, w)
    closest = a + v[..., None] * ab + w[..., None] * ac
    return closest, v, w


def detect_passive(obstacles, xs):
    """Deepest passive hit per query point across all obstacles.

    Mirrors Collider::detect's payload-min semantics
    (src/Collider.hpp:178-189): each obstacle only overwrites the payload
    if its dx is smaller. Returns (dx, point, normal, hit_mask, overflow);
    overflow is the OR over obstacles whose fixed-capacity machinery
    (near-lane compaction) dropped lanes this call.
    """
    ovf = jnp.asarray(False)
    if not obstacles:
        z3 = jnp.zeros(xs.shape, xs.dtype)
        big = jnp.full(xs.shape[:-1], jnp.finfo(xs.dtype).max, xs.dtype)
        return big, z3, z3, jnp.zeros(xs.shape[:-1], dtype=bool), ovf
    dxs, points, normals = [], [], []
    for obs in obstacles:
        if hasattr(obs, "signed_distance_with_overflow"):
            d, p, n, o = obs.signed_distance_with_overflow(xs)
            ovf = ovf | o
        else:
            d, p, n = obs.signed_distance(xs)
        dxs.append(d)
        points.append(p)
        normals.append(n)
    dx = jnp.stack(dxs, axis=0)  # [O, ...]
    best = jnp.argmin(dx, axis=0)
    pick = lambda arr: jnp.take_along_axis(
        jnp.stack(arr, axis=0), best[None, ..., None], axis=0
    )[0]
    d_best = jnp.take_along_axis(dx, best[None, ...], axis=0)[0]
    return d_best, pick(points), pick(normals), d_best < 0.0, ovf


# numpy helpers for SDF baking -------------------------------------------------

def _points_in_tets_np(pts, verts, tets, chunk=65536):
    x4 = verts[tets]  # [T,4,3]
    e = np.stack([x4[:, 1] - x4[:, 0], x4[:, 2] - x4[:, 0], x4[:, 3] - x4[:, 0]], axis=-1)
    einv = np.linalg.inv(e)  # [T,3,3]
    base = x4[:, 0]  # [T,3]
    inside = np.zeros((len(pts),), dtype=bool)
    for s in range(0, len(pts), chunk):
        p = pts[s : s + chunk]
        # barycentric-ish coords b = einv @ (p - base): [P,T,3]
        d = p[:, None, :] - base[None, :, :]
        b = np.einsum("tij,ptj->pti", einv, d)
        ok = (b >= -1e-12).all(-1) & (b.sum(-1) <= 1 + 1e-12)
        inside[s : s + chunk] = ok.any(-1)
    return inside


def _point_tri_distance_np(pts, verts, faces, chunk=16384):
    a, b, c = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    out = np.empty((len(pts),), dtype=np.float64)
    for s in range(0, len(pts), chunk):
        p = pts[s : s + chunk][:, None, :]
        d = _pt_tri_np(p, a[None], b[None], c[None])
        out[s : s + chunk] = d.min(axis=1)
    return out


def _pt_tri_np(p, a, b, c):
    """Distance from points to triangles (Ericson's closest-point)."""
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = (ab * ap).sum(-1)
    d2 = (ac * ap).sum(-1)
    bp = p - b
    d3 = (ab * bp).sum(-1)
    d4 = (ac * bp).sum(-1)
    cp = p - c
    d5 = (ab * cp).sum(-1)
    d6 = (ac * cp).sum(-1)
    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    denom = np.maximum(va + vb + vc, 1e-300)
    v = np.clip(vb / denom, 0, 1)
    w = np.clip(vc / denom, 0, 1)
    # Region clamps
    v = np.where((d1 <= 0) & (d2 <= 0), 0.0, v)
    w = np.where((d1 <= 0) & (d2 <= 0), 0.0, w)
    v = np.where((d3 >= 0) & (d4 <= d3), 1.0, v)
    w = np.where((d3 >= 0) & (d4 <= d3), 0.0, w)
    v = np.where((d6 >= 0) & (d5 <= d6), 0.0, v)
    w = np.where((d6 >= 0) & (d5 <= d6), 1.0, w)
    e_ab = np.clip(np.where(np.abs(d1 - d3) > 1e-300, d1 / np.maximum(d1 - d3, 1e-300), 0), 0, 1)
    on_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    v = np.where(on_ab, e_ab, v)
    w = np.where(on_ab, 0.0, w)
    e_ac = np.clip(np.where(np.abs(d2 - d6) > 1e-300, d2 / np.maximum(d2 - d6, 1e-300), 0), 0, 1)
    on_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    v = np.where(on_ac, 0.0, v)
    w = np.where(on_ac, e_ac, w)
    e_bc = np.clip((d4 - d3) / np.maximum((d4 - d3) + (d5 - d6), 1e-300), 0, 1)
    on_bc = (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0)
    v = np.where(on_bc, 1.0 - e_bc, v)
    w = np.where(on_bc, e_bc, w)
    closest = a + v[..., None] * ab + w[..., None] * ac
    return np.linalg.norm(p - closest, axis=-1)
