"""Element-family batches (struct-of-arrays) and their host-side builders.

The reference stores one heap-allocated EnergyTerm object per element and
walks them with virtual dispatch (src/Solver.cpp:84-87). Here each element
*family* (same element type + constitutive model) is one struct-of-arrays
batch, so the local step is a handful of big batched kernels.

Builders consume numpy arrays and mirror the reference constructors:
- TetEnergyTerm ctor: rest edge inverse, volume=det/6, inverted-rest check,
  w = sqrt(bulk_modulus * volume) (src/TetEnergyTerm.cpp:31-48).
- TriEnergyTerm ctor: 2D rest pose from in-plane orthonormal basis,
  area=det/2, w = sqrt(k*area), strain-limit validation
  (src/TriEnergyTerm.cpp:29-51).
- SpringPin: weight = sqrt(2 * bulk_modulus(rubber))
  (src/SpringEnergyTerm.hpp:42-52).
"""

from __future__ import annotations

import os

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from admm_elastic_tpu.materials import Lame
from admm_elastic_tpu.ops import prox as prox_ops

# Local-step implementations (see local_step_path):
#  - "lapack": [T,3,3] AoS prox with the LAPACK/cuSOLVER SVD
#    (jnp.linalg.svd). Full f64 accuracy for the inversion-recovery and
#    reference-parity goldens; Jacobi on F^T F loses half the digits for
#    near-collapsed elements.
#  - "jnp": SoA rows prox (ops/hyper_soa.py, branch-free Jacobi SVD) as
#    plain jnp, fused by XLA.
#  - "triton": the same SoA body as one Pallas kernel through Triton
#    (ops/pallas_kernels.py); hyperelastic families only.
LOCAL_STEP_PATHS = ("lapack", "jnp", "triton")


def local_step_path(platform: str, dtype) -> str:
    """Trace-time choice of the local-step implementation.

    GPU f32 takes the kernel, the fastest of the three end to end on an
    H100 (PERF.md); everything else takes the LAPACK/cuSOLVER path.
    ``ops.prox.set_svd_impl`` overrides the choice: "lapack" forces the
    AoS path, "jacobi" the plain-jnp SoA path. The Pallas interpreter
    mode (tests) selects the kernel on any platform.
    """
    from admm_elastic_tpu.ops import pallas_kernels

    if pallas_kernels.interpret_mode():
        return "triton"
    impl = prox_ops._SVD_IMPL
    if impl == "lapack":
        return "lapack"
    if impl == "jacobi":
        return "jnp"
    gpu_f32 = platform == "gpu" and jnp.dtype(dtype) == jnp.dtype(jnp.float32)
    return "triton" if gpu_f32 else "lapack"


def _path(dtype) -> str:
    return local_step_path(jax.default_backend(), dtype)


# Selector matrices: rows are vertices, columns are rest-edge coordinates.
_S_TET = np.array(
    [[-1.0, -1.0, -1.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]
)
_S_TRI = np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]])


def _register(cls, data_fields, meta_fields):
    return jax.tree_util.register_dataclass(cls, data_fields=data_fields, meta_fields=meta_fields)


@dataclasses.dataclass(frozen=True)
class TetBatch:
    """A batch of tetrahedral FEM elements sharing one constitutive model."""

    inds: jax.Array  # i32 [T, 4] global vertex indices
    Dlocal: jax.Array  # [T, 4, 3] = S @ edges_inv
    vol: jax.Array  # [T]
    weight: jax.Array  # [T] ADMM weight sqrt(k * vol)
    mu: jax.Array  # [T]
    lam: jax.Array  # [T]
    kappa: jax.Array  # [T] spline compression stabilizer (0 unless spline)
    # Scatter-free D^T: vertex -> incident (tet*4+corner) table, i32 [N, K]
    # (ops.reduction.build_gather_table), attached at Solver.initialize when
    # the global vertex count is known. None -> scatter-add fallback.
    gather_idx: Optional[jax.Array] = None
    # Flat-stencil static fields (ops/stencil.py v2): per-slot Dlocal row
    # fields [5, 4, 3, cells], parity mask [cells] and dead-lane mask
    # [cells] (1.0 on padded lanes). Set only when `stencil` is set; the
    # element order is then slot-major over vertex-pitch-embedded cells
    # and n == 5 * cells >= n_live.
    st_dl: Optional[jax.Array] = None
    st_par: Optional[jax.Array] = None
    st_dead: Optional[jax.Array] = None
    model: str = "linear"  # static
    # Structured-lattice stencil meta (ops/stencil.py StencilMeta) or
    # None; static. When set, D/D^T skip the (slow) gathers entirely.
    stencil: Optional[tuple] = None
    # Number of REAL elements (excludes flat-stencil dead lanes).
    n_live: Optional[int] = None

    @property
    def n(self) -> int:
        return self.inds.shape[0]

    @property
    def n_real(self) -> int:
        return self.n_live if self.n_live is not None else self.n

    @property
    def bulk(self):
        return self.lam + (2.0 / 3.0) * self.mu

    def prox(self, zi, n_newton_iters: int = 8):
        """Prox of one batch. zi is [T, 3, 3] or SoA rows [9, T]."""
        from admm_elastic_tpu.ops import hyper_soa, soa

        rows = zi.ndim == 2
        if rows or _path(zi.dtype) != "lapack":
            f = tuple(zi[i] for i in range(9)) if rows else soa.unpack33(zi)
            if self.model == prox_ops.TET_LINEAR:
                out = soa.prox_tet_linear_tuple(f)
            else:
                out = hyper_soa.prox_tet_hyper_tuple(
                    f, self.model, self.mu, self.lam, self.kappa, self.bulk,
                    n_iters=n_newton_iters,
                )
            return jnp.stack(out, axis=0) if rows else soa.pack33(out)
        if self.model == prox_ops.TET_LINEAR:
            return prox_ops.prox_tet_linear(zi)
        return prox_ops.prox_tet_hyper(
            zi, self.model, self.mu, self.lam, self.kappa, self.bulk, n_iters=n_newton_iters
        )

    def local_step_rows(self, dix_rows, u_rows, n_newton_iters: int = 8):
        """Fused local step on SoA rows [9, T]: returns (z, u_new).

        zi = prox(dix + u); u_new = dix + u - zi, on the path that
        local_step_path picks for this platform and dtype.
        """
        from admm_elastic_tpu.ops import pallas_kernels

        path = _path(dix_rows.dtype)
        v = dix_rows + u_rows
        if path == "lapack":
            z = self.prox(v.T.reshape(-1, 3, 3), n_newton_iters)
            z_rows = z.reshape(-1, 9).T
            return z_rows, v - z_rows
        if path == "triton" and self.model != prox_ops.TET_LINEAR:
            return pallas_kernels.local_step_tet_hyper_pallas(
                dix_rows, u_rows, self.model, self.mu, self.lam, self.kappa,
                self.bulk, n_iters=n_newton_iters,
            )
        z = self.prox(v, n_newton_iters)
        return z, v - z

    def energy(self, F):
        if self.model == prox_ops.TET_LINEAR:
            return prox_ops.energy_tet_linear(F, self.bulk, self.vol)
        return prox_ops.energy_tet_hyper(
            F, self.model, self.mu, self.lam, self.kappa, self.bulk, self.vol
        )


_register(TetBatch,
          ("inds", "Dlocal", "vol", "weight", "mu", "lam", "kappa",
           "gather_idx", "st_dl", "st_par", "st_dead"),
          ("model", "stencil", "n_live"))


@dataclasses.dataclass(frozen=True)
class TriBatch:
    """A batch of triangle (cloth) FEM elements."""

    inds: jax.Array  # i32 [T, 3]
    Dlocal: jax.Array  # [T, 3, 2]
    area: jax.Array  # [T]
    weight: jax.Array  # [T]
    mu: jax.Array
    lam: jax.Array
    limit_min: jax.Array  # [T]
    limit_max: jax.Array  # [T]
    gather_idx: Optional[jax.Array] = None  # see TetBatch.gather_idx
    # Flat-stencil fields, see TetBatch: [S, 3, 2, cells] Dlocal rows and
    # the dead-lane mask [cells] (sheets have no parity field).
    st_dl: Optional[jax.Array] = None
    st_dead: Optional[jax.Array] = None
    model: str = "linear"
    # Regular-sheet stencil meta (ops/stencil.py TriStencilMeta) or None;
    # static. Auto-detected from the index array at build (no factory
    # hint): cloth grids make D/D^T pure streamed slices.
    stencil: Optional[tuple] = None
    n_live: Optional[int] = None  # real elements (excludes dead lanes)

    @property
    def n(self) -> int:
        return self.inds.shape[0]

    @property
    def n_real(self) -> int:
        return self.n_live if self.n_live is not None else self.n

    @property
    def bulk(self):
        return self.lam + (2.0 / 3.0) * self.mu

    def prox(self, zi, n_newton_iters: int = 8):
        """Prox of one cloth batch. zi is [T, 3, 2] or SoA rows [6, T]."""
        del n_newton_iters
        if zi.ndim == 2:
            from admm_elastic_tpu.ops import soa

            out = soa.prox_tri_tuple(
                tuple(zi[i] for i in range(6)), self.limit_min, self.limit_max
            )
            return jnp.stack(out, axis=0)
        return prox_ops.prox_tri(zi, self.limit_min, self.limit_max)

    def local_step_rows(self, dix_rows, u_rows, n_newton_iters: int = 8):
        """Fused cloth local step on SoA rows [6, T]: (z, u_new)."""
        v = dix_rows + u_rows
        z = self.prox(v, n_newton_iters)
        return z, v - z

    def energy(self, F):
        return prox_ops.energy_tri(F, self.bulk, self.area)


_register(
    TriBatch,
    ("inds", "Dlocal", "area", "weight", "mu", "lam", "limit_min",
     "limit_max", "gather_idx", "st_dl", "st_dead"),
    ("model", "stencil", "n_live"),
)


@dataclasses.dataclass(frozen=True)
class PinBatch:
    """All pinnable vertices (targets/active flags mutable at runtime).

    With the prefactored/Uzawa global step the *set* of pinnable vertices is
    fixed at initialize; only targets and active flags change
    (src/Solver.cpp:135-156). target/active are device arrays so
    ``set_pins`` never recompiles.
    """

    idx: jax.Array  # i32 [P]
    target: jax.Array  # [P, 3]
    active: jax.Array  # bool [P]
    weight: jax.Array  # [P]
    gather_idx: Optional[jax.Array] = None  # see TetBatch.gather_idx

    @property
    def n(self) -> int:
        return self.idx.shape[0]

    def prox(self, zi, n_newton_iters: int = 8):
        del n_newton_iters
        return prox_ops.prox_pin(zi, self.target, self.active)


_register(PinBatch, ("idx", "target", "active", "weight", "gather_idx"), ())


# ---------------------------------------------------------------------------
# Host-side builders (numpy)
# ---------------------------------------------------------------------------

def build_tet_batch(
    verts: np.ndarray,
    tets: np.ndarray,
    lame: Lame,
    model: str = "linear",
    vertex_offset: int = 0,
    dtype=np.float64,
    kappa: float = 0.0,
    lattice_dims=None,
    lattice_wrap: bool = False,
) -> TetBatch:
    """Build a TetBatch from rest vertices [V,3] and tet indices [T,4].

    Raises on inverted rest tets, like the reference ctor
    (src/TetEnergyTerm.cpp:42-44).
    """
    import jax.numpy as jnp

    verts = np.asarray(verts, dtype=np.float64).reshape(-1, 3)
    tets = np.asarray(tets, dtype=np.int64).reshape(-1, 4)
    x4 = verts[tets]  # [T, 4, 3]
    edges = np.stack(
        [x4[:, 1] - x4[:, 0], x4[:, 2] - x4[:, 0], x4[:, 3] - x4[:, 0]], axis=-1
    )  # [T, 3, 3] columns are edges
    det = np.linalg.det(edges)
    vol = det / 6.0
    if np.any(vol < 0):
        bad = int(np.argmax(vol < 0))
        raise ValueError(f"TetBatch: inverted initial tet at index {bad} (vol={vol[bad]})")
    edges_inv = np.linalg.inv(edges)
    Dlocal = np.einsum("jk,tkc->tjc", _S_TET, edges_inv)  # [T, 4, 3]
    k = lame.bulk_modulus()
    weight = np.sqrt(k * vol)
    T = tets.shape[0]
    stencil = None
    if lattice_dims is not None and not os.environ.get("ADMM_NO_STENCIL"):
        from admm_elastic_tpu.ops import stencil as stencil_mod

        stencil = stencil_mod.verify_lattice(tets, lattice_dims,
                                             base=vertex_offset,
                                             wrap=lattice_wrap)
    if stencil is not None:
        # Flat-stencil layout (ops/stencil.py v2): elements reordered
        # slot-major over vertex-pitch-embedded cells; dead lanes are
        # weight/volume/Dlocal zero (inert in D^T W^2, A, and energies)
        # with live material parameters (so the identity F injected by the
        # stencil D x keeps their prox at its fixed point).
        from admm_elastic_tpu.ops import stencil as stencil_mod

        plan = stencil_mod.tet_flat_plan(stencil)
        t_cap = plan.t_cap
        return TetBatch(
            inds=jnp.asarray(
                plan.spread_inds(tets, verts.shape[0], vertex_offset),
                dtype=np.int32),
            Dlocal=jnp.asarray(plan.take(Dlocal), dtype=dtype),
            vol=jnp.asarray(plan.take(vol), dtype=dtype),
            weight=jnp.asarray(plan.take(weight), dtype=dtype),
            mu=jnp.full((t_cap,), lame.mu, dtype=dtype),
            lam=jnp.full((t_cap,), lame.lam, dtype=dtype),
            kappa=jnp.full((t_cap,), kappa, dtype=dtype),
            st_dl=jnp.asarray(plan.dl_rows(Dlocal), dtype=dtype),
            st_par=jnp.asarray(plan.par, dtype=dtype),
            st_dead=jnp.asarray(plan.dead.astype(np.float64), dtype=dtype),
            model=model,
            stencil=stencil,
            n_live=T,
        )
    return TetBatch(
        inds=jnp.asarray(tets + vertex_offset, dtype=np.int32),
        Dlocal=jnp.asarray(Dlocal, dtype=dtype),
        vol=jnp.asarray(vol, dtype=dtype),
        weight=jnp.asarray(weight, dtype=dtype),
        mu=jnp.full((T,), lame.mu, dtype=dtype),
        lam=jnp.full((T,), lame.lam, dtype=dtype),
        kappa=jnp.full((T,), kappa, dtype=dtype),
        model=model,
        stencil=stencil,
    )


def build_tri_batch(
    verts: np.ndarray,
    tris: np.ndarray,
    lame: Lame,
    vertex_offset: int = 0,
    dtype=np.float64,
    detect_stencil: bool = True,
) -> TriBatch:
    """Build a TriBatch; validates strain limits and rest orientation
    (src/TriEnergyTerm.cpp:29-51)."""
    import jax.numpy as jnp

    if lame.limit_min > 1.0:
        raise ValueError("TriBatch: strain limit min should be -inf to 1")
    if lame.limit_max < 1.0:
        raise ValueError("TriBatch: strain limit max should be 1 to inf")

    verts = np.asarray(verts, dtype=np.float64).reshape(-1, 3)
    tris = np.asarray(tris, dtype=np.int64).reshape(-1, 3)
    x3 = verts[tris]  # [T, 3, 3]
    e12 = x3[:, 1] - x3[:, 0]
    e13 = x3[:, 2] - x3[:, 0]
    n1 = e12 / np.linalg.norm(e12, axis=-1, keepdims=True)
    t2 = e13 - np.sum(e13 * n1, axis=-1, keepdims=True) * n1
    n2 = t2 / np.linalg.norm(t2, axis=-1, keepdims=True)
    basis = np.stack([n1, n2], axis=-1)  # [T, 3, 2]
    edges = np.stack([e12, e13], axis=-1)  # [T, 3, 2]
    rest2d = np.einsum("tjr,tjc->trc", basis, edges)  # [T, 2, 2]
    det = np.linalg.det(rest2d)
    area = det / 2.0
    if np.any(area < 0):
        raise ValueError("TriBatch: inverted initial pose")
    rest_inv = np.linalg.inv(rest2d)
    Dlocal = np.einsum("jk,tkc->tjc", _S_TRI, rest_inv)  # [T, 3, 2]
    k = lame.bulk_modulus()
    weight = np.sqrt(k * area)
    T = tris.shape[0]
    stencil = None
    if detect_stencil and not os.environ.get("ADMM_NO_STENCIL"):
        from admm_elastic_tpu.ops import stencil as stencil_mod

        stencil = stencil_mod.verify_tri_grid(tris, base=vertex_offset,
                                              n_local_verts=len(verts))
    if stencil is not None:
        # Flat-stencil layout, see build_tet_batch. Material params and
        # strain limits are family-uniform, so dead lanes get the same
        # (benign) values: the identity F injected by the stencil D x
        # satisfies limit_min <= 1 <= limit_max, keeping their prox at its
        # fixed point.
        from admm_elastic_tpu.ops import stencil as stencil_mod

        plan = stencil_mod.tri_flat_plan(tris, stencil)
        t_cap = plan.t_cap
        return TriBatch(
            inds=jnp.asarray(
                plan.spread_inds(tris, len(verts), vertex_offset),
                dtype=np.int32),
            Dlocal=jnp.asarray(plan.take(Dlocal), dtype=dtype),
            area=jnp.asarray(plan.take(area), dtype=dtype),
            weight=jnp.asarray(plan.take(weight), dtype=dtype),
            mu=jnp.full((t_cap,), lame.mu, dtype=dtype),
            lam=jnp.full((t_cap,), lame.lam, dtype=dtype),
            limit_min=jnp.full((t_cap,), lame.limit_min, dtype=dtype),
            limit_max=jnp.full((t_cap,), lame.limit_max, dtype=dtype),
            st_dl=jnp.asarray(plan.dl_rows(Dlocal), dtype=dtype),
            st_dead=jnp.asarray(plan.dead.astype(np.float64), dtype=dtype),
            model="linear",
            stencil=stencil,
            n_live=T,
        )
    return TriBatch(
        inds=jnp.asarray(tris + vertex_offset, dtype=np.int32),
        Dlocal=jnp.asarray(Dlocal, dtype=dtype),
        area=jnp.asarray(area, dtype=dtype),
        weight=jnp.asarray(weight, dtype=dtype),
        mu=jnp.full((T,), lame.mu, dtype=dtype),
        lam=jnp.full((T,), lame.lam, dtype=dtype),
        limit_min=jnp.full((T,), lame.limit_min, dtype=dtype),
        limit_max=jnp.full((T,), lame.limit_max, dtype=dtype),
        model="linear",
        stencil=stencil,
    )


def build_pin_batch(
    inds: np.ndarray, targets: np.ndarray, active: Optional[np.ndarray] = None, dtype=np.float64
) -> PinBatch:
    import jax.numpy as jnp

    inds = np.asarray(inds, dtype=np.int64).reshape(-1)
    targets = np.asarray(targets, dtype=np.float64).reshape(-1, 3)
    P = inds.shape[0]
    if active is None:
        active = np.ones((P,), dtype=bool)
    # "really strong rubber" pin weight (src/SpringEnergyTerm.hpp:47-51)
    w = np.sqrt(Lame.rubber().bulk_modulus() * 2.0)
    return PinBatch(
        idx=jnp.asarray(inds, dtype=np.int32),
        target=jnp.asarray(targets, dtype=dtype),
        active=jnp.asarray(active),
        weight=jnp.full((P,), w, dtype=dtype),
    )
