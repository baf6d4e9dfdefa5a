"""Regression tests for environment-specific numerical workarounds."""

import numpy as np
import jax.numpy as jnp

from admm_elastic_tpu.ops import hyper_soa, reduction as red, soa
from admm_elastic_tpu.ops.svd3 import signed_svd3_jacobi


def _near_identity_f(t=64, seed=1):
    """Deformation gradients ~ I with tiny off-diagonals: after a couple of
    Jacobi sweeps the remaining off-diagonal entries are ~1e-28, driving
    theta = (aqq-app)/(2 apq) to ~1e24 — the regime where XLA:CPU f64
    sqrt(theta^2+1) returned NaN (jax 0.9.0) before the theta clamp."""
    rng = np.random.default_rng(seed)
    f = np.eye(3)[None] + 1e-2 * rng.standard_normal((t, 3, 3))
    f += 1e-14 * rng.standard_normal((t, 3, 3))
    return f


def test_svd_near_identity_no_nan_f64():
    f = _near_identity_f()
    U, S, V = soa.signed_svd3_soa(soa.unpack33(jnp.asarray(f)))
    for part in (U, S, V):
        for a in part:
            assert bool(jnp.isfinite(a).all())
    # Reconstruction check.
    rec = soa.pack33(soa.compose_usv(U, S, V))
    np.testing.assert_allclose(np.asarray(rec), f, atol=1e-10)

    U2, S2, V2 = signed_svd3_jacobi(jnp.asarray(f))
    assert bool(jnp.isfinite(S2).all())


def test_hyper_prox_near_identity_no_nan_f64():
    t = 64
    f = jnp.asarray(_near_identity_f(t))
    mu = jnp.full((t,), 3.57e6)
    lam = jnp.full((t,), 1.41e7)
    kap = jnp.zeros((t,))
    k = lam + (2.0 / 3.0) * mu
    out = hyper_soa.prox_tet_hyper_soa(f, "neohookean", mu, lam, kap, k)
    assert bool(jnp.isfinite(out).all())


def test_gather_table_matches_scatter():
    rng = np.random.default_rng(0)
    n, t = 37, 120
    inds = rng.integers(0, n, (t, 4))
    g = jnp.asarray(rng.standard_normal((t, 3, 3)))
    dloc = jnp.asarray(rng.standard_normal((t, 4, 3)))
    table = jnp.asarray(red.build_gather_table(inds, n))
    inds_j = jnp.asarray(inds, jnp.int32)
    got = red.tet_Dt(g, inds_j, dloc, n, table)
    want = red.tet_Dt(g, inds_j, dloc, n, None)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-12)


def test_gather_table_isolated_vertices():
    # Vertices with no incident elements must receive exactly zero.
    inds = np.array([[1, 2, 3, 4]])
    table = red.build_gather_table(inds, 6)
    g = jnp.ones((1, 3, 3))
    dloc = jnp.ones((1, 4, 3))
    out = np.asarray(red.tet_Dt(g, jnp.asarray(inds, jnp.int32), dloc, 6, jnp.asarray(table)))
    assert np.all(out[0] == 0.0) and np.all(out[5] == 0.0)
    assert np.all(out[1] != 0.0)


def test_direct_inv_precision_policy():
    """The inv-mode f32 product runs at Precision.HIGHEST for pinned and
    unpinned systems alike (solvers/direct.py): the GPU's lower tier
    (TF32) misses the 1.1e-5 one-apply bound (chip_smoke.py kernels
    phase), and unpinned systems' bare-mass modes amplify apply error
    across steps (Solver._refine_eff)."""
    import jax

    from admm_elastic_tpu.solvers import direct as direct_mod

    rng = np.random.default_rng(3)
    q = rng.standard_normal((8, 8))
    a = q @ q.T + 8.0 * np.eye(8)
    pin_rows = (np.array([0]), np.array([[1, 2]]),
                np.array([[0.1, 0.2]]), np.array([a[0, 0]]))
    b = jnp.asarray(rng.standard_normal((8, 3)), jnp.float32)
    for rows in (pin_rows, None):
        data = direct_mod.prepare(a, np.float32, mode="inv", pin_rows=rows)
        jaxpr = jax.make_jaxpr(direct_mod.solve)(data, b)
        precs = [e.params["precision"] for e in jaxpr.eqns
                 if e.primitive.name == "dot_general"]
        assert precs and all(
            p in (jax.lax.Precision.HIGHEST,
                  (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST))
            for p in precs), precs
        x = np.asarray(direct_mod.solve(data, b), np.float64)
        np.testing.assert_allclose(x, np.linalg.solve(a, np.asarray(b)),
                                   rtol=1e-5, atol=1e-6)
