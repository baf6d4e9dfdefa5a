"""Gather-free, element-axis-major D / D^T for structured meshes.

For lattice meshes (make_tet_blocks: nx*ny*nz cells, 5 tets each,
parity-alternating corner patterns — the reference's own beam/box
generator) and regular cloth sheets, the two gathers of the element
pipeline — x[inds] in D x and the vertex gather-table in D^T — are
STENCILS: every element corner sits at a constant grid offset from its
cell, so D and D^T are pure shifted streams with static addressing
instead of arbitrary-index gathers and scatter-adds.

Everything stays on [k, cells]-shaped arrays with the flat cell axis
last (contiguous), the layout of the banded SpMV (ops/spmv.py):

- elements of a stencil family are reordered SLOT-MAJOR over a cell grid
  EMBEDDED AT VERTEX PITCH: element t = slot * X*Y*Z + p where
  p = ci*Y*Z + cj*Z + ck. Cells with ci=nx / cj=ny / ck=nz do not exist;
  those lanes are DEAD elements (weight 0, Dlocal 0, volume 0) padded in
  at build so that a cell's corner (di,dj,dk) is always the vertex at
  flat offset di*Y*Z + dj*Z + dk — a constant 1-D shift;
- D x is then 8 static slices of the padded [3, XYZ] vertex stream
  blended by a flat parity mask, contracted against per-slot Dlocal
  row fields [5, 4, 3, XYZ];
- D^T is the transposed contraction + 8 shifted (padded) adds.

Zero gathers, zero scatters, full lanes. Dead lanes are made inert
end-to-end: D x injects an identity F into them (so prox/energy stay in
the hyperelastic domain), their weight/volume are 0 (so D^T W^2, the
assembled A, and energies never see them), and their `inds` are spread
cyclically over the family's vertices (so the gather-table fallback and
assembly stay well-shaped without concentrating pad rows on vertex 0).

The pattern is DETECTED from the actual index array at build time
(verify_lattice / verify_tri_grid); a user-permuted or hand-edited mesh
falls back to the gather path. Stencil and gather paths are exactly
equal in exact arithmetic on live lanes (same per-element contractions,
different addressing); f32/f64 summation order differs only in D^T where
a vertex's incident corners accumulate in corner-major instead of table
order.
"""

from __future__ import annotations

import dataclasses
from itertools import product
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

# meta: (base, X, Y, Z, pat_even, pat_odd, wrap) with pat_* a 5x4
# tuple-of-tuples of cube-corner ids (di*4 + dj*2 + dk), base the
# family's global vertex offset (meshes are staged consecutively), and
# wrap marking a PERIODIC first axis (ring lattices like the torus:
# X counts ring segments — cells AND vertices — and every corner shift
# is a flat roll instead of a padded slice).
StencilMeta = Tuple[int, int, int, int, tuple, tuple, bool]

_CORNERS = tuple(product((0, 1), (0, 1), (0, 1)))  # id = di*4 + dj*2 + dk


def _extract_pats(corner: np.ndarray, parity: np.ndarray,
                  slot: np.ndarray):
    pats = []
    for p in (0, 1):
        sel = parity == p
        if not sel.any():
            return None
        pat = np.zeros((5, 4), np.int64)
        for s in range(5):
            rows = corner[sel & (slot == s)]
            if rows.shape[0] == 0:
                return None
            pat[s] = rows[0]
            if not (rows == rows[0]).all():
                return None
        pats.append(tuple(tuple(int(v) for v in r) for r in pat))
    return pats


def verify_lattice(inds: np.ndarray, dims: Tuple[int, int, int],
                   base: int = 0,
                   wrap: bool = False) -> Optional[StencilMeta]:
    """Check LOCAL inds [T,4] (0-based within the mesh) against an
    (nx,ny,nz)-cell lattice; extract the per-(parity, slot, corner)
    cube-corner pattern or return None. `base` is the family's global
    vertex offset recorded into the meta.

    wrap=True verifies a RING lattice instead (make_tet_torus): the
    first axis is periodic — nx ring segments of cells AND vertices,
    first-axis corner deltas taken modulo nx (nx must be even so the
    parity pattern closes around the seam)."""
    nx, ny, nz = dims
    if wrap and nx % 2 != 0:
        return None
    X = nx if wrap else nx + 1
    Y, Z = ny + 1, nz + 1
    inds = np.asarray(inds)
    t = inds.shape[0]
    if t != nx * ny * nz * 5 or inds.shape[1] != 4:
        return None
    cell = np.arange(t) // 5
    slot = np.arange(t) % 5
    ci = cell // (ny * nz)
    cj = (cell // nz) % ny
    ck = cell % nz
    ii = inds // (Y * Z)
    jj = (inds // Z) % Y
    kk = inds % Z
    di = (ii - ci[:, None]) % nx if wrap else ii - ci[:, None]
    dj = jj - cj[:, None]
    dk = kk - ck[:, None]
    if not ((di >= 0) & (di <= 1) & (dj >= 0) & (dj <= 1)
            & (dk >= 0) & (dk <= 1)).all():
        return None
    corner = di * 4 + dj * 2 + dk  # [T, 4]
    parity = (ci + cj + ck) % 2
    pats = _extract_pats(corner, parity, slot)
    if pats is None:
        return None
    return (int(base), X, Y, Z, pats[0], pats[1], bool(wrap))


# ---------------------------------------------------------------------------
# Host-side flat plan (element reorder + static fields)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FlatPlan:
    """Host plan mapping a detected stencil family to its flat layout.

    src: i64 [T_cap] — original element index per new slot-major element,
      -1 for dead (padded) lanes.
    dead: bool [cells] — True on embedded cells that do not exist.
    par: f64 [cells] — 1.0 on even-parity cells (tets; all-ones for tris).
    dl_shape: the [S, arity, cols, cells] shape of the Dlocal row fields.
    """

    src: np.ndarray
    dead: np.ndarray
    par: np.ndarray
    n_slots: int
    arity: int
    cols: int

    @property
    def t_cap(self) -> int:
        return self.src.shape[0]

    def take(self, a: np.ndarray, fill=0.0) -> np.ndarray:
        """Permute a per-element array into flat order, filling dead lanes."""
        a = np.asarray(a)
        out = np.full((self.t_cap,) + a.shape[1:], fill, dtype=a.dtype)
        live = self.src >= 0
        out[live] = a[self.src[live]]
        return out

    def dl_rows(self, Dlocal: np.ndarray) -> np.ndarray:
        """[T, arity, cols] -> [S, arity, cols, cells] lane-major fields."""
        d = self.take(np.asarray(Dlocal, np.float64))
        cells = self.t_cap // self.n_slots
        return np.ascontiguousarray(
            d.reshape(self.n_slots, cells, self.arity, self.cols)
            .transpose(0, 2, 3, 1))

    def spread_inds(self, inds: np.ndarray, n_local: int,
                    base: int) -> np.ndarray:
        """Flat-order global inds; dead lanes cycle over the family's
        vertices so no single vertex collects all pad corners (keeps the
        gather-table fallback's K bounded)."""
        arity = inds.shape[1]
        out = self.take(np.asarray(inds, np.int64) + base, fill=0)
        dead_rows = np.nonzero(self.src < 0)[0]
        if dead_rows.size:
            spread = (dead_rows[:, None] * arity
                      + np.arange(arity)[None, :]) % n_local + base
            out[dead_rows] = spread
        return out


def tet_flat_plan(meta: StencilMeta) -> FlatPlan:
    base, X, Y, Z, pe, po, wrap = meta
    # Cells embed at vertex pitch in (j, k) only; the OUTERMOST axis needs
    # no +1 slab (its corner shift just reads one slab ahead), so the flat
    # cell array is nx*Y*Z — at 40x5x5 this cuts dead lanes 47% -> 30%.
    nx = X if wrap else X - 1  # ring lattices have no +1 on the wrap axis
    ny, nz = Y - 1, Z - 1
    ci, cj, ck = np.meshgrid(np.arange(nx), np.arange(Y), np.arange(Z),
                             indexing="ij")
    live = (cj < ny) & (ck < nz)
    cells = nx * Y * Z
    # Original order: t = ((ci*ny + cj)*nz + ck)*5 + s (cell-major).
    cell_id = (ci * ny + cj) * nz + ck
    src_cell = np.where(live, cell_id, -1).reshape(-1)  # [cells]
    par = ((ci + cj + ck) % 2 == 0).astype(np.float64).reshape(-1)
    dead = ~live.reshape(-1)
    src = np.empty((5 * cells,), np.int64)
    for s in range(5):
        src[s * cells:(s + 1) * cells] = np.where(
            src_cell >= 0, src_cell * 5 + s, -1)
    return FlatPlan(src=src, dead=dead, par=par,
                    n_slots=5, arity=4, cols=3)


def _tet_geom(meta: StencilMeta):
    base, X, Y, Z, pe, po, wrap = meta
    YZ = Y * Z
    nx = X if wrap else X - 1
    cells = nx * YZ  # flat cell array (vertex pitch in j/k; no +1 slab)
    n_vblock = X * YZ  # the family's vertex block
    offs = tuple(di * YZ + dj * Z + dk for (di, dj, dk) in _CORNERS)
    return base, cells, n_vblock, offs, pe, po, wrap


def tet_Dx_rows(x, b):
    """Flat-stencil D x -> SoA rows [9, T_cap] (slot-major element order).

    Dead lanes receive an identity F so prox/energy stay well-defined;
    their weight/volume are 0 so they never influence the solve.
    """
    base, cells, n_vblock, offs, pe, po, wrap = _tet_geom(b.stencil)
    maxd = max(offs)
    xT = x[base:base + n_vblock].T  # [3, verts] — lane-major stream
    if wrap:
        # Periodic first axis: corner (di,dj,dk) of cell p is vertex
        # (p + d) mod cells. One wrap-extended concat turns every modular
        # read into the same static slices as the non-wrap path. (Live
        # cells never overflow the cross-section; dead-lane garbage reads
        # are killed by dl = 0.)
        xp = jnp.concatenate([xT, xT[:, :maxd]], axis=1)
    else:
        xp = jnp.pad(xT, ((0, 0), (0, cells + maxd - n_vblock)))
    xc = [jax.lax.slice_in_dim(xp, d, d + cells, axis=1) for d in offs]
    par = b.st_par  # [cells], 1.0 on even cells
    inv = 1.0 - par
    dl = b.st_dl  # [5, 4, 3, cells]
    dead = b.st_dead  # [cells], 1.0 on dead lanes
    xsel = [[(xc[pe[s][j]] if pe[s][j] == po[s][j]
              else par * xc[pe[s][j]] + inv * xc[po[s][j]])
             for j in range(4)] for s in range(5)]
    rows = []
    for r in range(3):
        for c in range(3):
            per_slot = [
                sum(xsel[s][j][r] * dl[s, j, c] for j in range(4))
                for s in range(5)
            ]
            if r == c:
                per_slot = [ps + dead for ps in per_slot]
            rows.append(jnp.stack(per_slot, axis=0))  # [5, cells]
    return jnp.stack(rows, axis=0).reshape(9, -1)


def tet_Dt_rows(G_rows, b, n_verts):
    """Flat-stencil D^T G from SoA rows [9, T_cap] -> [N, 3].

    Callers pre-multiply G by w^2, which is 0 on dead lanes, so no
    live-masking is needed here.
    """
    base, cells, n_vblock, offs, pe, po, wrap = _tet_geom(b.stencil)
    maxd = max(offs)
    g = G_rows.reshape(3, 3, 5, cells)
    dl = b.st_dl
    par = b.st_par
    inv = 1.0 - par
    acc = [None] * 8
    for s in range(5):
        for j in range(4):
            contrib = jnp.stack([
                sum(g[r, c, s] * dl[s, j, c] for c in range(3))
                for r in range(3)
            ], axis=0)  # [3, cells]
            he, ho = pe[s][j], po[s][j]
            if he == ho:
                acc[he] = contrib if acc[he] is None else acc[he] + contrib
            else:
                e = par * contrib
                o = inv * contrib
                acc[he] = e if acc[he] is None else acc[he] + e
                acc[ho] = o if acc[ho] is None else acc[ho] + o
    out = jnp.zeros((3, cells + maxd), dtype=G_rows.dtype)
    for cid, d in enumerate(offs):
        if acc[cid] is None:
            continue
        out = out + jnp.pad(acc[cid], ((0, 0), (d, maxd - d)))
    if wrap:
        # out[(p + d) mod cells] += acc[p]: fold the wrap tail back onto
        # the head (dead lanes carry zeros — w^2 = 0 pre-multiplied).
        head = out[:, :maxd] + out[:, cells:cells + maxd]
        outT = jnp.concatenate([head, out[:, maxd:cells]], axis=1).T
    else:
        outT = out[:, :n_vblock].T  # the family's vertex block
    if base == 0 and n_vblock == n_verts:
        return outT
    return jnp.pad(outT, ((base, n_verts - base - n_vblock), (0, 0)))


# ---------------------------------------------------------------------------
# Triangle sheet stencil (cloth grids)
# ---------------------------------------------------------------------------
#
# Regular cloth sheets (matrix.py _cloth_solver, ref_driver model 3,
# geometry.factory.make_plane) triangulate a vertex grid with a CONSTANT
# per-slot corner pattern — no parity alternation. Unlike the tet path the
# grid is DETECTED with no factory hint: the fast-axis pitch G1 is inferred
# from the first triangles' index differences and every candidate is fully
# verified against all T index rows, so a false positive is impossible
# (the checks *are* the addressing equivalence).

# meta: (base, G0, G1, pats) — vertex grid [G0, G1] with
# vid = slow * G1 + fast; pats an S x 3 tuple of corner ids ds * 2 + df
# in (slow, fast) axes. The flat layout always embeds cells at vertex
# pitch p = cs * G1 + cf regardless of the original enumeration order.
TriStencilMeta = Tuple[int, int, int, tuple]

_CORNERS2 = ((0, 0), (0, 1), (1, 0), (1, 1))  # (ds, df), id = ds*2 + df


def _check_tri_grid(inds: np.ndarray, v: int, g1: int, base: int):
    g0 = v // g1
    if g0 < 2 or g1 < 2:
        return None
    slow, fast = inds // g1, inds % g1
    cs, cf = slow.min(axis=1), fast.min(axis=1)
    ds, df = slow - cs[:, None], fast - cf[:, None]
    if not ((ds >= 0) & (ds <= 1) & (df >= 0) & (df <= 1)).all():
        return None
    n_s, n_f = g0 - 1, g1 - 1
    t = inds.shape[0]
    if t % (n_s * n_f):
        return None
    s_cnt = t // (n_s * n_f)
    if not 1 <= s_cnt <= 8:
        return None
    cell = np.arange(t) // s_cnt
    slot = np.arange(t) % s_cnt
    if (cs == cell // n_f).all() and (cf == cell % n_f).all():
        pass  # slow-major enumeration
    elif (cf == cell // n_s).all() and (cs == cell % n_s).all():
        pass  # fast-major enumeration
    else:
        return None
    corner = ds * 2 + df  # [T, 3] in (slow, fast) axes
    pats = []
    for s in range(s_cnt):
        rows = corner[slot == s]
        if rows.shape[0] == 0 or not (rows == rows[0]).all():
            return None
        pats.append(tuple(int(x) for x in rows[0]))
    return (int(base), g0, g1, tuple(pats))


def verify_tri_grid(inds: np.ndarray, base: int = 0,
                    n_local_verts: Optional[int] = None
                    ) -> Optional[TriStencilMeta]:
    """Detect a regular-sheet triangulation from LOCAL inds [T, 3] alone.

    Tries fast-axis pitches implied by the first triangles' index
    differences (the grid pitch or its +-1 neighbors show up there in
    every standard sheet triangulation) and fully verifies each candidate;
    returns the meta or None."""
    inds = np.asarray(inds)
    if inds.ndim != 2 or inds.shape[1] != 3 or inds.shape[0] < 2:
        return None
    v = int(n_local_verts if n_local_verts is not None else inds.max() + 1)
    head = inds[: min(4, inds.shape[0])]
    diffs = np.abs(head[:, :, None] - head[:, None, :]).reshape(-1)
    cands = set()
    for d in diffs[diffs > 0]:
        for g in (int(d) - 1, int(d), int(d) + 1):
            if 2 <= g <= v // 2 and v % g == 0:
                cands.add(g)
    for g1 in sorted(cands):
        meta = _check_tri_grid(inds, v, g1, base)
        if meta is not None:
            return meta
    return None


def tri_flat_plan(inds: np.ndarray, meta: TriStencilMeta) -> FlatPlan:
    """Flat plan for a sheet: slot-major over cells at vertex pitch G1.

    The original element order (slow- or fast-major cell enumeration) is
    recovered from the index array itself, so src is exact either way.
    """
    base, g0, g1, pats = meta
    s_cnt = len(pats)
    n_s, n_f = g0 - 1, g1 - 1
    inds = np.asarray(inds)
    slow, fast = inds // g1, inds % g1
    cs, cf = slow.min(axis=1), fast.min(axis=1)
    # Original element t sits at embedded cell p and slot t % s_cnt.
    p_orig = cs * g1 + cf  # [T]
    slot_orig = np.arange(inds.shape[0]) % s_cnt
    cells = g0 * g1
    src = np.full((s_cnt * cells,), -1, np.int64)
    src[slot_orig * cells + p_orig] = np.arange(inds.shape[0])
    a, bb = np.meshgrid(np.arange(g0), np.arange(g1), indexing="ij")
    live = (a < n_s) & (bb < n_f)
    return FlatPlan(src=src, dead=~live.reshape(-1),
                    par=np.ones((cells,), np.float64),
                    n_slots=s_cnt, arity=3, cols=2)


def _tri_geom(meta: TriStencilMeta):
    base, g0, g1, pats = meta
    cells = g0 * g1
    offs = tuple(ds * g1 + df for (ds, df) in _CORNERS2)
    return base, cells, offs, pats


def tri_Dx_rows(x, b):
    """Flat-stencil D x for a sheet -> SoA rows [6, T_cap].

    Dead lanes receive the identity 3x2 F (rows 0 and 3 = 1)."""
    base, cells, offs, pats = _tri_geom(b.stencil)
    s_cnt = len(pats)
    maxd = max(offs)
    xT = x[base:base + cells].T  # [3, cells]
    xp = jnp.pad(xT, ((0, 0), (0, maxd)))
    xc = [jax.lax.slice_in_dim(xp, d, d + cells, axis=1) for d in offs]
    dl = b.st_dl  # [S, 3, 2, cells]
    dead = b.st_dead
    rows = []
    for r in range(3):
        for c in range(2):
            per_slot = [
                sum(xc[pats[s][j]][r] * dl[s, j, c] for j in range(3))
                for s in range(s_cnt)
            ]
            if (r, c) in ((0, 0), (1, 1)):
                per_slot = [ps + dead for ps in per_slot]
            rows.append(jnp.stack(per_slot, axis=0))
    return jnp.stack(rows, axis=0).reshape(6, -1)


def tri_Dt_rows(G_rows, b, n_verts):
    """Flat-stencil D^T G from SoA rows [6, T_cap] -> [N, 3]."""
    base, cells, offs, pats = _tri_geom(b.stencil)
    s_cnt = len(pats)
    maxd = max(offs)
    g = G_rows.reshape(3, 2, s_cnt, cells)
    dl = b.st_dl
    acc = [None] * 4
    for s in range(s_cnt):
        for j in range(3):
            contrib = jnp.stack([
                sum(g[r, c, s] * dl[s, j, c] for c in range(2))
                for r in range(3)
            ], axis=0)  # [3, cells]
            cid = pats[s][j]
            acc[cid] = contrib if acc[cid] is None else acc[cid] + contrib
    out = jnp.zeros((3, cells + maxd), dtype=G_rows.dtype)
    for cid, d in enumerate(offs):
        if acc[cid] is None:
            continue
        out = out + jnp.pad(acc[cid], ((0, 0), (d, maxd - d)))
    outT = out[:, :cells].T
    if base == 0 and cells == n_verts:
        return outT
    return jnp.pad(outT, ((base, n_verts - base - cells), (0, 0)))
