"""Prefactored direct solver (the reference's LDLTSolver, src/LinearSolver.hpp:59-92).

A is component-decoupled, so we factor the N x N single-component
matrix once at initialize (host, f64) and per ADMM iteration do two
triangular solves with the 3 coordinates as batched RHS. Optionally
("inv" mode) the explicit inverse is precomputed so the per-iteration
solve is a single [N,N] @ [N,3] matrix product; "cho" keeps triangular
solves.

Like the reference, this solver cannot handle collision constraints
(Solver::initialize throws if obstacles are present with linsolver=0,
src/Solver.cpp:249-254).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class DirectData:
    mat: jax.Array  # [N, N]: Cholesky factor L ("cho") or (SAS)^-1 ("inv")
    scale: jax.Array  # [N, 1] Jacobi equilibration s = diag(A)^(-1/2) ("inv")
    # Pin-row polish data (None when there are no pin energies): the f32
    # inverse matmul's error concentrates on the pin rows (diag ~1e5 x the
    # rest), and those rows are strongly diagonally dominant, so a couple
    # of Jacobi sweeps restricted to them restores "infinitely hard" pin
    # behavior (measured 2.4e-2 -> 1e-5 deviation) for the cost of one
    # tiny gather — ~20x cheaper than a full iterative-refinement pass.
    pin_idx: "jax.Array | None" = None  # i32 [P]
    pin_cols: "jax.Array | None" = None  # i32 [P, K] off-diag columns
    pin_vals: "jax.Array | None" = None  # [P, K]
    pin_diag: "jax.Array | None" = None  # [P]
    mode: str = "cho"


jax.tree_util.register_dataclass(
    DirectData,
    data_fields=("mat", "scale", "pin_idx", "pin_cols", "pin_vals", "pin_diag"),
    meta_fields=("mode",),
)


def polish(data: DirectData, x, b, sweeps: int = 2):
    """Jacobi sweeps on the pin rows of A x = b (no-op without pin data)."""
    if data.pin_idx is None:
        return x
    for _ in range(sweeps):
        off = jnp.sum(data.pin_vals[:, :, None] * x[data.pin_cols], axis=1)
        x = x.at[data.pin_idx].set((b[data.pin_idx] - off) / data.pin_diag[:, None])
    return x


def prepare(A_dense: np.ndarray, dtype, mode: str = "cho",
            pin_rows=None) -> DirectData:
    """One-time factorization (host, always f64 for stability).

    "inv" stores the inverse of the *Jacobi-equilibrated* matrix B = S A S,
    S = diag(A)^(-1/2), applied as x = S (B^-1 (S b)). Equilibration drops
    the stored matrix's condition number by the diagonal spread (pins put
    ~dt^2 w_pin^2 on their diagonal entries, ~1e5 x the rest), which is
    exactly the f32 cancellation error an un-scaled A^-1 matmul suffers.
    """
    pin_kw = {}
    if pin_rows is not None:
        pin_idx, pin_cols, pin_vals, pin_diag = pin_rows
        pin_kw = dict(
            pin_idx=jnp.asarray(pin_idx, jnp.int32),
            pin_cols=jnp.asarray(pin_cols, jnp.int32),
            pin_vals=jnp.asarray(pin_vals, dtype=dtype),
            pin_diag=jnp.asarray(pin_diag, dtype=dtype),
        )
    if mode == "inv":
        d = np.sqrt(np.diag(A_dense))
        s = 1.0 / d
        B = A_dense * s[:, None] * s[None, :]
        Binv = np.linalg.inv(B)
        return DirectData(
            mat=jnp.asarray(Binv, dtype=dtype),
            scale=jnp.asarray(s[:, None], dtype=dtype),
            mode="inv",
            **pin_kw,
        )
    L = np.linalg.cholesky(A_dense)
    return DirectData(
        mat=jnp.asarray(L, dtype=dtype),
        scale=jnp.ones((L.shape[0], 1), dtype=dtype),
        mode="cho",
        **pin_kw,
    )


def solve(data: DirectData, b):
    """x = A^-1 b for b [N, k] (k=3 coordinates as batched RHS).

    The inv-mode product runs at Precision.HIGHEST (full f32). A lower
    tier (TF32 on the GPU's tensor cores) keeps about three decimal
    digits; the repeated solves feed that error into the trajectory, and
    on unpinned systems the bare-mass modes amplify it across steps
    (Solver._refine_eff). chip_smoke.py's kernels phase measures the
    one-apply error of both tiers against an f64 solve.
    """
    if data.mode == "inv":
        return data.scale * jnp.matmul(
            data.mat, data.scale * b, precision=jax.lax.Precision.HIGHEST
        )
    y = jax.scipy.linalg.solve_triangular(data.mat, b, lower=True)
    return jax.scipy.linalg.solve_triangular(data.mat.T, y, lower=False)
