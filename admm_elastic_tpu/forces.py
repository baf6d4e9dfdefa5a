"""Explicit (pre-ADMM) forces applied to velocities before prediction.

Reference: src/ExplicitForce.{hpp,cpp}. Explicit forces are applied to v
before computing x_bar (src/Solver.cpp:53-54). WindForce implements the
Wejchert-Haumann (1991) aerodynamics model per triangle; the reference
scatters to nodes under `#pragma omp critical`
(src/ExplicitForce.cpp:95-103), here it is one segment scatter-add.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


class ExplicitForce:
    """Interface: project(dt, x, v, m) -> new v."""

    def project(self, dt, x, v, m):
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class WindForce(ExplicitForce):
    """Wejchert-Haumann wind on a triangle list.

    Three application orders:
    - batched (default): every triangle reads the pre-kick velocities and
      the per-triangle forces scatter-add — the parallel, vectorized form.
    - sequential: each triangle reads velocities already updated by the
      previous triangles, exactly matching the reference's single-threaded
      loop (src/ExplicitForce.cpp:55-104; its OpenMP form races on v, so
      the serial order IS its deterministic semantic). The sequential
      order is Gauss-Seidel-like and noticeably more stable when the kick
      per step approaches the relative wind speed; batched is Jacobi-like
      (a vertex of valence k absorbs ~k simultaneous kicks) and diverges
      on scenes the reference survives.
    - colored: triangles greedily colored so no color shares a vertex;
      colors apply in sequence, each as one batched update. Within a
      color the updates are independent (vertex-disjoint), so this has
      sequential's Gauss-Seidel stability at ~n_colors batched steps
      instead of a W-step scan — the vectorized stable form. The
      serialization differs from the reference's file order, so results
      deviate from `sequential` only at the O((dt kick)^2) order-
      dependence of the model itself.
    """

    tris: jax.Array  # i32 [W, 3]
    direction: jax.Array  # [3]
    alpha_n: float = 1000.0  # normal coupling strength (static)
    sequential: bool = False  # static
    # Colored mode arrays (None -> batched/sequential per flag above):
    # [C, L] triangle indices per color (pad = W) + validity mask.
    color_tris: "jax.Array | None" = None
    color_mask: "jax.Array | None" = None

    def _tri_force(self, dt, p, vv):
        curr_v = jnp.mean(vv, axis=-2)
        # Cast to the state dtype: a f64 direction against f32 state would
        # promote the whole force chain (and trip the f64->f32 scatter
        # deprecation warning).
        v_r = curr_v - self.direction.astype(vv.dtype)
        a = p[..., 1, :] - p[..., 0, :]
        bb = p[..., 2, :] - p[..., 0, :]
        n_raw = jnp.cross(a, bb)
        n_len = jnp.linalg.norm(n_raw, axis=-1)
        normal = n_raw / jnp.maximum(n_len, 1e-30)[..., None]
        area = 0.5 * n_len
        v_n = jnp.sum(normal * v_r, axis=-1)
        force = (-self.alpha_n * area * v_n * jnp.abs(v_n))[..., None] * normal
        return force * 0.33 * dt

    def project(self, dt, x, v, m):
        del m
        if self.sequential:
            def body(v_carry, tri):
                force = self._tri_force(dt, x[tri], v_carry[tri])
                return v_carry.at[tri].add(force), None

            v_out, _ = jax.lax.scan(body, v, self.tris)
            return v_out
        if self.color_tris is not None:
            w = self.tris.shape[0]
            for c in range(self.color_tris.shape[0]):
                idx = jnp.minimum(self.color_tris[c], w - 1)  # [L]
                msk = self.color_mask[c]
                tri = self.tris[idx]  # [L, 3] vertex ids (disjoint in-color)
                force = self._tri_force(dt, x[tri], v[tri])
                force = jnp.where(msk[:, None], force, 0.0)
                contrib = jnp.broadcast_to(force[:, None, :], (idx.shape[0], 3, 3))
                v = v.at[tri.reshape(-1)].add(contrib.reshape(-1, 3))
            return v
        p = x[self.tris]  # [W, 3, 3]
        vv = v[self.tris]
        force = self._tri_force(dt, p, vv)
        # Same force added to all three nodes (src/ExplicitForce.cpp:95-102).
        contrib = jnp.broadcast_to(force[:, None, :], vv.shape)
        return v.at[self.tris.reshape(-1)].add(contrib.reshape(-1, 3))


jax.tree_util.register_dataclass(
    WindForce,
    data_fields=("tris", "direction", "color_tris", "color_mask"),
    meta_fields=("alpha_n", "sequential"),
)


def _color_triangles(tris: np.ndarray):
    """Greedy coloring of the triangle graph (edges = shared vertices).

    Host-side, one-time (topology is static). Returns ([C, L] i32 padded
    with W, [C, L] bool mask)."""
    w = len(tris)
    vert_tris: dict = {}
    for t, tri in enumerate(tris):
        for vtx in tri:
            vert_tris.setdefault(int(vtx), []).append(t)
    colors = -np.ones(w, dtype=np.int64)
    for t in range(w):
        used = set()
        for vtx in tris[t]:
            for u in vert_tris[int(vtx)]:
                if colors[u] >= 0:
                    used.add(int(colors[u]))
        c = 0
        while c in used:
            c += 1
        colors[t] = c
    n_colors = int(colors.max()) + 1 if w else 0
    groups = [np.where(colors == c)[0] for c in range(n_colors)]
    lmax = max((len(g) for g in groups), default=1)
    out = np.full((n_colors, lmax), w, dtype=np.int32)
    mask = np.zeros((n_colors, lmax), dtype=bool)
    for c, g in enumerate(groups):
        out[c, : len(g)] = g
        mask[c, : len(g)] = True
    return out, mask


def make_wind_force(tris: np.ndarray, direction=(0.0, 0.0, 0.0), dtype=np.float64,
                    sequential: bool = False, colored: bool = False) -> WindForce:
    tris_np = np.asarray(tris, dtype=np.int64).reshape(-1, 3)
    color_tris = color_mask = None
    if colored and not sequential:
        ct, cm = _color_triangles(tris_np)
        color_tris = jnp.asarray(ct)
        color_mask = jnp.asarray(cm)
    return WindForce(
        sequential=sequential,
        tris=jnp.asarray(tris_np, dtype=jnp.int32),
        direction=jnp.asarray(direction, dtype=dtype),
        color_tris=color_tris,
        color_mask=color_mask,
    )
