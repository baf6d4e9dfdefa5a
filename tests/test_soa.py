"""SoA-layout kernels must match the AoS reference implementations."""

import numpy as np
import jax.numpy as jnp

from admm_elastic_tpu.materials import Lame
from admm_elastic_tpu.ops import hyper_soa, prox as prox_ops, soa
from admm_elastic_tpu.ops.svd3 import signed_svd3_jacobi


def rand_F(rng, n, with_degenerate=True):
    F = np.eye(3) + 0.7 * rng.normal(size=(n, 3, 3))
    F[: n // 4, :, 0] *= -1.0
    F[0] = np.eye(3)
    if with_degenerate:
        F[1] = 0.0  # fully collapsed: prox is non-unique (any rotation)
    return jnp.asarray(F)


def test_signed_svd_soa_matches_aos():
    F = rand_F(np.random.default_rng(0), 64)
    U, S, V = soa.signed_svd3_soa(soa.unpack33(F), sweeps=8)
    Ua, Sa, Va = signed_svd3_jacobi(F, sweeps=8)
    recon = soa.pack33(soa.compose_usv(U, S, V))
    assert np.abs(np.asarray(recon) - np.asarray(F)).max() < 1e-8
    np.testing.assert_allclose(np.asarray(soa.pack3(S)), np.asarray(Sa), atol=1e-8)


def test_prox_linear_soa_matches():
    F = rand_F(np.random.default_rng(1), 64, with_degenerate=False)
    a = prox_ops.prox_tet_linear(F)
    b = soa.prox_tet_linear_soa(F, sweeps=10)
    assert np.abs(np.asarray(a) - np.asarray(b)).max() < 1e-7

    # Degenerate input: the projection is non-unique, but the output must
    # still be 0.5*(rotation + F) -> singular values all 0.5 for F = 0.
    z = jnp.zeros((4, 3, 3))
    out = np.asarray(soa.prox_tet_linear_soa(z))
    sv = np.linalg.svd(out, compute_uv=False)
    np.testing.assert_allclose(sv, 0.5, atol=1e-8)


def test_prox_hyper_soa_matches():
    rng = np.random.default_rng(2)
    lame = Lame.from_youngs_poisson(1e6, 0.3)
    n = 48
    F = rand_F(rng, n, with_degenerate=False)
    mu = jnp.full((n,), lame.mu)
    lam = jnp.full((n,), lame.lam)
    k = jnp.full((n,), lame.bulk_modulus())
    zero = jnp.zeros((n,))
    for model in ("neohookean", "stvk", "spline_nh", "spline_stvk", "spline_corot"):
        kap = k if model.startswith("spline") else zero
        a = prox_ops.prox_tet_hyper(F, model, mu, lam, kap, k, n_iters=15)
        b = hyper_soa.prox_tet_hyper_soa(F, model, mu, lam, kap, k, n_iters=15, sweeps=10)
        err = np.abs(np.asarray(a) - np.asarray(b)).max()
        # Both converge to the same prox point; differences come from the
        # SVD basis in (near-)degenerate cases.
        assert err < 5e-4, (model, err)


def test_tri_rows_layout_matches_aos():
    """Rows-layout cloth pipeline (Dx rows, prox tuple, Dt rows) matches
    the AoS forms exactly."""
    import jax.numpy as jnp
    import numpy as np

    from admm_elastic_tpu.ops import prox as prox_ops
    from admm_elastic_tpu.ops import reduction as red
    from admm_elastic_tpu.ops import soa

    rng = np.random.default_rng(7)
    n, t = 40, 60
    x = jnp.asarray(rng.standard_normal((n, 3)))
    inds = jnp.asarray(rng.integers(0, n, (t, 3)), jnp.int32)
    dl = jnp.asarray(rng.standard_normal((t, 3, 2)))

    aos = red.tri_Dx(x, inds, dl)
    rows = red.tri_Dx_rows(x, inds, dl)
    np.testing.assert_allclose(
        np.asarray(rows).T.reshape(t, 3, 2), np.asarray(aos), atol=1e-13
    )

    lm = jnp.asarray(np.where(rng.random(t) < 0.5, 0.95, -100.0))
    lx = jnp.asarray(np.where(np.asarray(lm) > 0, 1.05, 100.0))
    want = prox_ops.prox_tri(aos, lm, lx)
    got = soa.prox_tri_tuple(tuple(rows[i] for i in range(6)), lm, lx)
    got = np.stack([np.asarray(g) for g in got], axis=1).reshape(t, 3, 2)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-12)

    g = jnp.asarray(rng.standard_normal((t, 3, 2)))
    g_rows = jnp.stack([g[:, r, c] for r in range(3) for c in range(2)])
    table = jnp.asarray(red.build_gather_table(np.asarray(inds), n))
    a = red.tri_Dt(g, inds, dl, n, table)
    b = red.tri_Dt_rows(g_rows, inds, dl, n, table)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-13)
