"""Matrix-free Jacobi-preconditioned conjugate gradient (extension, ls=3).

The scalable replacement for the prefactored direct solver when N x N dense
is no longer reasonable: each iteration is one matrix-free A apply (gathers
+ batched contraction + segment scatter, see system.A_mv) plus a few
axpys/dots. Because A acts identically on the three coordinates, the whole
[N, 3] state is treated as a single Krylov vector. Dot products reduce over
all entries, so under sharding they lower to psum over the mesh axis.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class PCGData:
    """Precomputed operator data for the PCG global step.

    Two storage forms for the off-diagonal of A, chosen at prepare():

    - Banded/DIA (the fast path): band_offsets/bands hold the popular
      constant diagonals of A in a locality-preserving vertex order, and
      the apply is shift+fma on a [3, N] transposed state, streamed at
      memory bandwidth.
      Mesh graphs in lattice/RCM order put ~100% of nnz on a few dozen
      diagonals, so this covers every structured scene and, via the RCM
      permutation (perm/iperm), scrambled orderings too.
    - Padded ELL row gather (fallback): arbitrary-index gathers read far
      below streaming bandwidth — kept only for graphs with no banded
      structure, and
      for the thin "rest" of nnz off the popular diagonals (gather cost
      scales with N*K_rest, so a thin rest stays cheap).

    Topology and weights are fixed at initialize so A's entries are too.
    The stiffness part is kept separate from the mass diagonal so a
    per-scene stiffness sweep is a scalar rescale (parallel/batch.py);
    ALL off-diagonal entries are stiffness, so the sweep scales bands and
    rest alike.
    """

    # With bands active these hold only the thin REST (entries off the
    # popular diagonals, K often 0); otherwise the full off-diagonal.
    ell_cols: jax.Array  # i32 [N, K] off-diagonal neighbor columns
    ell_vals: jax.Array  # [N, K] off-diagonal A entries (pad = 0)
    diag_mass: jax.Array  # [N] lumped masses
    diag_stiff: jax.Array  # [N] dt^2 D^T W^2 D element (tet/tri) diagonal
    # [N] pin contribution dt^2 w_pin^2 (pins hit only the diagonal: their
    # D row is a single 1). Kept apart from diag_stiff because a per-scene
    # stiffness sweep (parallel/batch.py) scales *material* stiffness only;
    # scaling the pin diagonal too would make the operator disagree with
    # the unscaled pin rhs and pinned vertices would settle at ~target/scale.
    diag_pin: jax.Array  # [N]
    # Two-grid preconditioner level (None -> plain Jacobi). agg maps each
    # vertex to its aggregate; coarse_inv is the dense inverse of the
    # Galerkin coarse operator P^T A P (piecewise-constant P), so both
    # transfers are one segment_sum / one gather and the coarse solve is
    # one dense matrix product. Iteration counts stay bounded as the mesh grows
    # (Jacobi CG grows ~O(1/h)): 160k-tet beam, tol 1e-6: 77 -> 18 iters.
    agg: Optional[jax.Array] = None  # i32 [N]
    # [C, Kc] vertex-gather table for the restriction P^T (scatter-free;
    # pad entries point one past the last row — see reduction.dt_gather).
    agg_gather: Optional[jax.Array] = None
    coarse_inv: Optional[jax.Array] = None  # [C, C]
    # Banded/DIA fast path (None -> ELL row gather). offsets are static
    # (meta field): the apply unrolls one shift+fma per diagonal.
    bands: Optional[jax.Array] = None  # [D, N] A[i, i+off_d] in band order
    # Optional RCM vertex permutation making A banded when the native
    # order is not (row i of the banded operator is vertex perm[i]).
    perm: Optional[jax.Array] = None  # i64 [N]
    iperm: Optional[jax.Array] = None  # i64 [N]
    band_offsets: Tuple[int, ...] = ()
    # Offsets are mod-N (centered) and the apply wraps — periodic meshes
    # (ops/spmv.py BandPlan.circular).
    band_circular: bool = False

    def diag(self, scale=None):
        d = self.diag_stiff if scale is None else scale * self.diag_stiff
        return self.diag_mass + self.diag_pin + d

    def precondition(self, scale=None, omega: float = 0.7):
        """Returns M^-1 apply: Jacobi, or a symmetric two-grid V-cycle
        (damped-Jacobi smooth, coarse correction, damped-Jacobi smooth)
        when the coarse level is attached."""
        inv_d = (1.0 / self.diag(scale))[:, None]
        if self.agg is None:
            return lambda r: inv_d * r

        n_c = self.coarse_inv.shape[0]

        from admm_elastic_tpu.ops.reduction import dt_gather

        def apply_m(r):
            z = omega * inv_d * r
            res = r - self.apply(z, scale)
            rc = dt_gather(res, self.agg_gather)  # P^T res, scatter-free
            ec = jnp.matmul(self.coarse_inv, rc,
                            precision=jax.lax.Precision.HIGHEST)
            z = z + ec[self.agg]
            z = z + omega * inv_d * (r - self.apply(z, scale))
            return z

        return apply_m

    def apply(self, x, scale=None):
        """A x for x [N, k]."""
        off = self.off_apply(x, scale)
        return self.diag(scale)[:, None] * x + off

    def precondition_T(self, scale=None, omega: float = 0.7):
        """M^-1 apply on LANE-MAJOR [k, N] vectors (see solve_T).

        Jacobi is layout-native; the two-grid V-cycle (vertex gathers +
        coarse matmul) keeps its [N, k] form behind boundary transposes.
        """
        if self.agg is None:
            inv_d = (1.0 / self.diag(scale))[None, :]
            return lambda rT: inv_d * rT
        m = self.precondition(scale, omega)
        return lambda rT: m(rT.T).T

    def apply_T(self, xT, scale=None):
        """A x for LANE-MAJOR xT [k, N] — the CG-internal layout.

        On the banded fast path this skips both per-apply transposes
        (measured [3, N] streams at 871 GB/s vs 156 for [N, 3]); the
        rest-ELL / no-bands gather paths transpose at the boundary.
        """
        if self.bands is not None and self.perm is None \
                and not self.ell_cols.shape[1]:
            off = self._banded_T(xT, scale)
            return self.diag(scale)[None, :] * xT + off
        return self.apply(xT.T, scale).T

    def _banded_T(self, xT, scale=None):
        bands = self.bands if scale is None else scale * self.bands
        lo = max(-min(self.band_offsets), 0)
        hi = max(max(self.band_offsets), 0)
        n = xT.shape[1]
        if self.band_circular:
            # Wrap-extended ends: x[(i+o) mod N] = xp[:, i + lo + o].
            xp = jnp.concatenate(
                [xT[:, n - lo:], xT, xT[:, :hi]], axis=1)
        else:
            xp = jnp.pad(xT, ((0, 0), (lo, hi)))
        acc = jnp.zeros_like(xT)
        for i, o in enumerate(self.band_offsets):
            acc = acc + bands[i][None, :] * jax.lax.dynamic_slice_in_dim(
                xp, lo + o, n, axis=1)
        return acc

    def off_apply(self, x, scale=None):
        """Off-diagonal apply: banded shift+fma (+ thin rest) or ELL."""
        if self.bands is None:
            vals = self.ell_vals if scale is None else scale * self.ell_vals
            return jnp.sum(vals[:, :, None] * x[self.ell_cols], axis=1)
        xb = x if self.perm is None else x[self.perm]
        # [3, N] transpose: the shifted fma streams with N on lanes
        # (measured 5.2 us vs 29 us for the [N, 3] layout at 160k tets).
        off = self._banded_T(xb.T, scale).T
        if self.ell_cols.shape[1]:
            vals = self.ell_vals if scale is None else scale * self.ell_vals
            off = off + jnp.sum(vals[:, :, None] * xb[self.ell_cols], axis=1)
        return off if self.perm is None else off[self.iperm]


jax.tree_util.register_dataclass(
    PCGData,
    data_fields=("ell_cols", "ell_vals", "diag_mass", "diag_stiff", "diag_pin", "agg", "agg_gather", "coarse_inv", "bands", "perm", "iperm"),
    meta_fields=("band_offsets", "band_circular"),
)


def prepare(system, dtype, precond: str = "jacobi",
            agg_size: int = 24, spmv_format: str = "auto") -> PCGData:
    """One-time operator assembly of A (host).

    precond in {"jacobi", "twogrid"}; spmv_format in {"auto", "bands",
    "ell"} — "auto" takes the banded/DIA fast path when the popular
    diagonals (after RCM if needed) cover >= 90% of the off-diagonal nnz,
    which holds for every lattice/sheet mesh and for most unstructured
    meshes once RCM-ordered.
    """
    from admm_elastic_tpu.system import assembly

    ell_cols, ell_vals, diag = assembly.assemble_ell(system, dtype=np.float64)
    bands = perm = iperm = None
    band_offsets = ()
    band_circular = False
    if spmv_format in ("auto", "bands") and ell_cols.shape[1]:
        from admm_elastic_tpu.ops import spmv

        plan = spmv.plan_bands(ell_cols, ell_vals)
        if plan.offsets and (plan.coverage >= 0.9 or spmv_format == "bands"):
            band_offsets = plan.offsets
            band_circular = plan.circular
            bands = jnp.asarray(plan.bands, dtype=dtype)
            ell_cols = plan.rest_cols
            ell_vals = plan.rest_vals
            if plan.perm is not None:
                perm = jnp.asarray(plan.perm)
                iperm = jnp.asarray(plan.iperm)
    elif spmv_format != "ell" and spmv_format not in ("auto", "bands"):
        raise ValueError(f"unknown spmv_format {spmv_format!r}")
    masses = np.asarray(system.masses, dtype=np.float64)
    pin_diag = np.zeros_like(masses)
    if system.pins is not None:
        dt2 = system.dt * system.dt
        w2 = np.asarray(system.pins.weight, dtype=np.float64) ** 2
        np.add.at(pin_diag, np.asarray(system.pins.idx), dt2 * w2)
    agg = agg_gather = coarse_inv = None
    if precond == "twogrid":
        adj = assembly.vertex_adjacency(system)
        agg_np = assembly.greedy_aggregates(adj, target_size=agg_size)
        a_c = assembly.coarse_matrix(system, agg_np)
        d_c = np.sqrt(np.diag(a_c))
        s_c = 1.0 / d_c
        b_inv = np.linalg.inv(a_c * s_c[:, None] * s_c[None, :])
        from admm_elastic_tpu.ops.reduction import build_gather_table

        agg = jnp.asarray(agg_np)
        agg_gather = jnp.asarray(build_gather_table(agg_np[:, None], int(agg_np.max()) + 1))
        coarse_inv = jnp.asarray(s_c[:, None] * b_inv * s_c[None, :], dtype=dtype)
    elif precond != "jacobi":
        raise ValueError(f"unknown pcg preconditioner {precond!r}")
    return PCGData(
        ell_cols=jnp.asarray(ell_cols),
        ell_vals=jnp.asarray(ell_vals, dtype=dtype),
        diag_mass=jnp.asarray(masses, dtype=dtype),
        diag_stiff=jnp.asarray(diag - masses - pin_diag, dtype=dtype),
        diag_pin=jnp.asarray(pin_diag, dtype=dtype),
        agg=agg,
        agg_gather=agg_gather,
        coarse_inv=coarse_inv,
        bands=bands,
        perm=perm,
        iperm=iperm,
        band_offsets=band_offsets,
        band_circular=band_circular,
    )


def solve(A_mv, precond, b, x0, tol, max_iters):
    """Solve A x = b with preconditioned CG.

    Args:
      A_mv: callable [N,3] -> [N,3].
      precond: M^-1 apply — a callable [N,3] -> [N,3], or a [N] Jacobi
        diagonal (wrapped automatically).
      b, x0: [N, 3].
      tol: relative residual tolerance (on ||r||/||b||).
      max_iters: traced or static int bound.
    Returns (x, iters).
    """
    if callable(precond):
        apply_m = precond
    else:
        inv_d = (1.0 / precond)[:, None]
        apply_m = lambda r: inv_d * r

    def dot(a, b_):
        return jnp.sum(a * b_)

    b_norm2 = dot(b, b)
    # Clamp to the dtype's achievable relative residual: the reference
    # default tol=1e-10 is below f32 machine precision, which would
    # force max_iters every solve (in f64 the clamp is a no-op).
    tol = jnp.maximum(tol, 64 * jnp.finfo(b.dtype).eps)
    tol2 = tol * tol * jnp.maximum(b_norm2, jnp.finfo(b.dtype).tiny)

    r0 = b - A_mv(x0)
    z0 = apply_m(r0)
    p0 = z0
    rz0 = dot(r0, z0)

    def cond(carry):
        _, r, _, _, k, done = carry
        return (~done) & (k < max_iters)

    def body(carry):
        (x, r, p, rz, k, _) = carry
        Ap = A_mv(p)
        denom = dot(p, Ap)
        alpha = rz / jnp.where(jnp.abs(denom) < jnp.finfo(b.dtype).tiny, 1.0, denom)
        x = x + alpha * p
        r = r - alpha * Ap
        z = apply_m(r)
        rz_new = dot(r, z)
        beta = rz_new / jnp.where(jnp.abs(rz) < jnp.finfo(b.dtype).tiny, 1.0, rz)
        p = z + beta * p
        done = dot(r, r) < tol2
        return (x, r, p, rz_new, k + 1, done)

    init = (x0, r0, p0, rz0, jnp.asarray(0, jnp.int32), dot(r0, r0) < tol2)
    x, _, _, _, iters, _ = jax.lax.while_loop(cond, body, init)
    return x, iters


def solve_T(A_mv_T, precond_T, b, x0, tol, max_iters):
    """solve() with LANE-MAJOR [k, N] internals.

    CG spends its non-apply time in axpys/dots over the state vectors;
    the [N, 3] layout streams at 156 GB/s vs 871 for [3, N] (DESIGN.md
    hw probes), so the iteration loop runs transposed — two boundary
    transposes per SOLVE instead of several slow passes per ITERATION.
    A_mv_T / precond_T consume and produce [k, N] (PCGData.apply_T /
    precondition_T). b, x0 and the returned x stay [N, k].
    """
    bT = b.T
    x0T = x0.T

    def dot(a, b_):
        return jnp.sum(a * b_)

    b_norm2 = dot(bT, bT)
    tol = jnp.maximum(tol, 64 * jnp.finfo(b.dtype).eps)
    tol2 = tol * tol * jnp.maximum(b_norm2, jnp.finfo(b.dtype).tiny)

    r0 = bT - A_mv_T(x0T)
    z0 = precond_T(r0)
    rz0 = dot(r0, z0)

    def cond(carry):
        _, r, _, _, k, done = carry
        return (~done) & (k < max_iters)

    def body(carry):
        (x, r, p, rz, k, _) = carry
        Ap = A_mv_T(p)
        denom = dot(p, Ap)
        alpha = rz / jnp.where(jnp.abs(denom) < jnp.finfo(b.dtype).tiny, 1.0, denom)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond_T(r)
        rz_new = dot(r, z)
        beta = rz_new / jnp.where(jnp.abs(rz) < jnp.finfo(b.dtype).tiny, 1.0, rz)
        p = z + beta * p
        done = dot(r, r) < tol2
        return (x, r, p, rz_new, k + 1, done)

    init = (x0T, r0, z0, rz0, jnp.asarray(0, jnp.int32), dot(r0, r0) < tol2)
    xT, _, _, _, iters, _ = jax.lax.while_loop(cond, body, init)
    return xT.T, iters


def solve_traced(A_mv, precond, b, x0, n_iters: int, x_star=None,
                 err_denom=None):
    """Fixed-length PCG with a per-iteration residual trace (SolverLog tier).

    The reference hooks SolverLog into every LinearSolver::solve to record
    error-vs-known-solution per inner iteration (src/SolverLog.hpp:36-55,
    src/UzawaCG.hpp:112). Early exit would make the trace shape dynamic, so
    this variant runs exactly n_iters as a lax.scan and emits the whole
    curve as a scan output: res [n_iters] = ||b - A x_k||, and err
    [n_iters] = ||x* - x_k|| / ||x* - x_0|| when x_star is given.

    Returns (x, {"res": [n_iters], "err": [n_iters] | None}).
    """
    if callable(precond):
        apply_m = precond
    else:
        inv_d = (1.0 / precond)[:, None]
        apply_m = lambda r: inv_d * r

    def dot(a, b_):
        return jnp.sum(a * b_)

    if x_star is not None and err_denom is None:
        err_denom = jnp.maximum(jnp.linalg.norm(x_star - x0),
                                jnp.finfo(b.dtype).tiny)

    r0 = b - A_mv(x0)
    z0 = apply_m(r0)
    tiny = jnp.finfo(b.dtype).tiny

    def body(carry, _):
        x, r, p, rz = carry
        Ap = A_mv(p)
        denom = dot(p, Ap)
        alpha = rz / jnp.where(jnp.abs(denom) < tiny, 1.0, denom)
        # Freeze once converged-to-noise (denom ~ 0): keeps the tail flat
        # instead of NaN, so traces are zero-padded-flat like the reference
        # log simply stopping.
        alpha = jnp.where(jnp.abs(denom) < tiny, 0.0, alpha)
        x = x + alpha * p
        r = r - alpha * Ap
        z = apply_m(r)
        rz_new = dot(r, z)
        beta = rz_new / jnp.where(jnp.abs(rz) < tiny, 1.0, rz)
        beta = jnp.where(jnp.abs(rz) < tiny, 0.0, beta)
        p = z + beta * p
        res = jnp.sqrt(dot(r, r))
        err = (jnp.linalg.norm(x_star - x) / err_denom
               if x_star is not None else jnp.asarray(0.0, b.dtype))
        return (x, r, p, rz_new), (res, err)

    (x, _, _, _), (res, err) = jax.lax.scan(
        body, (x0, r0, z0, dot(r0, z0)), None, length=n_iters
    )
    return x, {"res": res, "err": (err if x_star is not None else None)}
