"""Fused local-step kernel (Pallas through Triton): interpreter-mode
exactness vs the jnp SoA path, tail masking, vmap, the path choice, the
round-to-nearest rewrite of its f32 division and square root, and its
split over a mesh's shard axis.

The kernel shares its numerical body with ops/hyper_soa.py, so on
identical inputs it must agree with the jnp path to reassociation noise.
The CPU suite runs it in the Pallas interpreter
(set_pallas_mode("interpret")); on the GPU the same code compiles through
Triton (chip_smoke.py's kernels phase, and the `gpu`-marked test here).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from admm_elastic_tpu.ops import hyper_soa, pallas_kernels
from admm_elastic_tpu.ops import prox as prox_ops
from admm_elastic_tpu.ops.prox import TET_NEOHOOKEAN, TET_STVK
from admm_elastic_tpu.system import elements as el


@pytest.fixture(autouse=True)
def _interpret_mode():
    pallas_kernels.set_pallas_mode("interpret")
    yield
    pallas_kernels.set_pallas_mode("auto")


def _random_f(t, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    # Mix of near-identity, stretched, and inverted deformation gradients.
    f = np.eye(3)[None] + 0.4 * rng.standard_normal((t, 3, 3))
    f[:: 5] *= -1.0  # inverted
    f[1:: 7] *= 3.0  # large stretch
    return f.astype(dtype)


def _params(t, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    mu = rng.uniform(1e4, 1e6, t).astype(dtype)
    lam = rng.uniform(1e4, 1e6, t).astype(dtype)
    return mu, lam, np.zeros(t, dtype), lam + (2.0 / 3.0) * mu


def _jnp_local_step(dix, u, model, mu, lam, kappa, k):
    v = dix + u
    z = jnp.stack(hyper_soa.prox_tet_hyper_tuple(
        tuple(v[i] for i in range(9)), model, mu, lam, kappa, k), axis=0)
    return z, v - z


@pytest.mark.parametrize("model", [TET_NEOHOOKEAN, TET_STVK])
def test_hyper_prox_matches_soa(model):
    t = 300
    zi = _random_f(t, seed=3)
    mu, lam, kappa, k = _params(t, 4)
    rows = jnp.asarray(zi.reshape(t, 9).T)
    got, _ = pallas_kernels.local_step_tet_hyper_pallas(
        rows, jnp.zeros_like(rows), model, mu, lam, kappa, k)
    want = np.asarray(
        hyper_soa.prox_tet_hyper_soa(zi, model, mu, lam, kappa, k)
    )
    np.testing.assert_allclose(np.asarray(got).T.reshape(t, 3, 3), want,
                               rtol=1e-10, atol=1e-10)


def test_f32_padding_lanes_stay_finite():
    # The tail block's masked lanes read an identity F; output must be
    # finite and the live lanes unaffected (t chosen to leave a tail).
    t = 130
    zi = _random_f(t, seed=9, dtype=np.float32)
    rows = jnp.asarray(zi.reshape(t, 9).T)
    mu = np.full(t, 1e5, np.float32)
    lam = np.full(t, 2e5, np.float32)
    kappa = np.zeros(t, np.float32)
    k = lam + (2.0 / 3.0) * mu
    z, un = pallas_kernels.local_step_tet_hyper_pallas(
        rows, jnp.zeros_like(rows), TET_NEOHOOKEAN, mu, lam, kappa, k)
    assert z.shape == (9, t) and un.shape == (9, t)
    assert np.isfinite(np.asarray(z)).all() and np.isfinite(np.asarray(un)).all()


def test_fused_local_step_tet_matches_jnp():
    """Fused z+dual-update kernel == prox + manual dual update."""
    t = 200
    rng = np.random.default_rng(11)
    dix = jnp.asarray(rng.standard_normal((9, t)) * 0.3
                      + np.asarray([1, 0, 0, 0, 1, 0, 0, 0, 1])[:, None])
    u = jnp.asarray(rng.standard_normal((9, t)) * 0.05)
    mu, lam, kap, k = (jnp.asarray(a) for a in _params(t, 12))
    z, un = pallas_kernels.local_step_tet_hyper_pallas(
        dix, u, TET_NEOHOOKEAN, mu, lam, kap, k
    )
    want, want_u = _jnp_local_step(dix, u, TET_NEOHOOKEAN, mu, lam, kap, k)
    np.testing.assert_allclose(np.asarray(z), np.asarray(want), atol=1e-10)
    np.testing.assert_allclose(np.asarray(un), np.asarray(want_u), atol=1e-10)


@pytest.mark.parametrize("t", [1, 127, 129, 1500])
def test_kernel_tail_masking_matches_jnp(t):
    """Element counts below, across and far beyond one block: the masked
    tail loads/stores leave every live element equal to the jnp body."""
    rows = jnp.asarray(_random_f(t, seed=t).reshape(t, 9).T)
    u = jnp.asarray(np.random.default_rng(t + 1).standard_normal((9, t))
                    * 0.05)
    mu, lam, kap, k = (jnp.asarray(a) for a in _params(t, t + 2))
    z, un = pallas_kernels.local_step_tet_hyper_pallas(
        rows, u, TET_STVK, mu, lam, kap, k)
    assert pallas_kernels.BLOCK == 128
    want, want_u = _jnp_local_step(rows, u, TET_STVK, mu, lam, kap, k)
    assert z.shape == (9, t)
    np.testing.assert_allclose(np.asarray(z), np.asarray(want),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(np.asarray(un), np.asarray(want_u),
                               rtol=1e-10, atol=1e-10)


def test_kernel_under_vmap_matches_per_scene():
    """make_batched_step vmaps the local step over scenes, with material
    parameters scaled per scene (parallel/batch.py _scale_system)."""
    t, s = 70, 3
    rows = jnp.asarray(_random_f(t, seed=5).reshape(t, 9).T)
    dix = jnp.stack([rows * (1.0 + 0.1 * i) for i in range(s)])
    u = jnp.zeros_like(dix)
    mu, lam, kap, k = (jnp.asarray(a) for a in _params(t, 6))
    scale = jnp.asarray([0.5, 1.0, 2.0])

    def one(d, uu, sc):
        return pallas_kernels.local_step_tet_hyper_pallas(
            d, uu, TET_NEOHOOKEAN, mu * sc, lam * sc, kap, k * sc)

    z, _ = jax.vmap(one)(dix, u, scale)
    for i in range(s):
        want, _ = _jnp_local_step(dix[i], u[i], TET_NEOHOOKEAN, mu * scale[i],
                                  lam * scale[i], kap, k * scale[i])
        np.testing.assert_allclose(np.asarray(z[i]), np.asarray(want),
                                   rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("platform,dtype,impl,want", [
    ("cpu", np.float64, "auto", "lapack"),
    ("cpu", np.float32, "auto", "lapack"),
    ("gpu", np.float64, "auto", "lapack"),
    ("gpu", np.float32, "auto", "triton"),
    ("gpu", np.float32, "lapack", "lapack"),
    ("cpu", np.float32, "jacobi", "jnp"),
    ("gpu", np.float32, "jacobi", "jnp"),
])
def test_local_step_path_choice(platform, dtype, impl, want):
    pallas_kernels.set_pallas_mode("auto")
    prox_ops.set_svd_impl(impl)
    try:
        assert el.local_step_path(platform, dtype) == want
    finally:
        prox_ops.set_svd_impl("auto")
    # The interpreter switch (tests) selects the kernel on any platform.
    pallas_kernels.set_pallas_mode("interpret")
    assert el.local_step_path(platform, dtype) == "triton"


def test_solver_steps_match_jnp_path():
    """Three pinned-beam solver steps through the kernel (interpreter)
    vs the jnp SoA path (reference semantics: src/Solver.cpp:84-98)."""
    from admm_elastic_tpu import Settings, Solver, binding
    from admm_elastic_tpu.geometry.factory import make_tet_blocks

    def run():
        solver = Solver()
        mesh = make_tet_blocks(4, 2, 2)
        mesh.flags = binding.NEOHOOKEAN | binding.NOSELFCOLLISION
        binding.add_tetmesh(solver, mesh, verbose=False)
        solver.set_pins([0, 2])
        solver.initialize(Settings(linsolver=0, admm_iters=4, verbose=0))
        for _ in range(3):
            solver.step()
        return np.asarray(solver.x)

    x_kernel = run()
    pallas_kernels.set_pallas_mode("auto")
    prox_ops.set_svd_impl("jacobi")
    try:
        x_jnp = run()
    finally:
        prox_ops.set_svd_impl("auto")
    np.testing.assert_allclose(x_kernel, x_jnp, rtol=1e-10, atol=1e-12)


def _count_hits(fn, *args):
    """Evaluate fn with every f32 div and sqrt re-bound through the
    rewriter unchanged; return (outputs, hits per primitive)."""
    hits = {}

    def same(prim, aval, *a):
        hits[prim.name] = hits.get(prim.name, 0) + 1
        return prim.bind(*[jnp.broadcast_to(x, aval.shape).astype(aval.dtype)
                           for x in a])

    out = jax.jit(pallas_kernels.replace_primitives(
        fn, {jax.lax.div_p: same, jax.lax.sqrt_p: same}))(*args)
    return out, hits


@pytest.mark.parametrize("model", [TET_NEOHOOKEAN, TET_STVK])
def test_rewriter_is_exact_and_reaches_loop_bodies(model):
    """The kernel's round-to-nearest rewrite re-evaluates the body's
    jaxpr through inner jits and loops: with each replacement re-binding
    the same primitive it is bit-exact, and it reaches every div and sqrt
    (the loop-form body keeps them inside scans)."""
    t = 64
    rows = _random_f(t, seed=8, dtype=np.float32).reshape(t, 9).T
    mu, lam, kap, k = (a.astype(np.float32) for a in _params(t, 9))

    def body(v, mu, lam, kappa, k):
        return hyper_soa.prox_tet_hyper_tuple(
            tuple(v[i] for i in range(9)), model, mu, lam, kappa, k,
            unroll=False)

    want = jax.jit(body)(rows, mu, lam, kap, k)
    got, hits = _count_hits(body, rows, mu, lam, kap, k)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    jaxpr = jax.make_jaxpr(body)(rows, mu, lam, kap, k)

    def count(j, name):
        n = 0
        for e in j.eqns:
            n += e.primitive.name == name and e.outvars[0].aval.dtype == np.float32
            for v in e.params.values():
                for x in (v if isinstance(v, (tuple, list)) else (v,)):
                    if hasattr(x, "jaxpr") and hasattr(x, "consts"):
                        n += count(x.jaxpr, name)
        return n

    assert hits == {"div": count(jaxpr.jaxpr, "div"),
                    "sqrt": count(jaxpr.jaxpr, "sqrt")}
    assert hits["div"] > 0 and hits["sqrt"] > 0


@pytest.mark.parametrize("model", [TET_NEOHOOKEAN, TET_STVK])
def test_kernel_lowers_with_round_to_nearest(model):
    """Lowered for the GPU (no card needed), the Triton kernel carries no
    f32 arith.divf (Triton's div.full.f32) and no libdevice sqrtf
    (sqrt.approx.f32): its divisions and square roots are the
    round-to-nearest PTX that XLA and the CPU also use."""
    pallas_kernels.set_pallas_mode("auto")
    t = 300
    d = jnp.ones((9, t), jnp.float32)
    p = jnp.ones((t,), jnp.float32)
    txt = jax.jit(
        lambda *a: pallas_kernels.local_step_tet_hyper_pallas(
            a[0], a[1], model, *a[2:])
    ).trace(d, d, p, p, p, p).lower(lowering_platforms=("cuda",)).as_text()
    assert "__gpu$xla.gpu.triton" in txt
    start = txt.index('ir = "')
    ir = txt[start:txt.index('"', start + 6)]
    assert "divf" not in ir and "__nv_sqrtf" not in ir
    assert "div.rn.f32" in ir and "sqrt.rn.f32" in ir


def test_kernel_splits_over_shard_axis():
    """Under a 1x4 (scene, shard) mesh the batched step runs the kernel
    on a quarter of the (padded) element axis on each device, and agrees
    with one device."""
    from admm_elastic_tpu.parallel.batch import (make_batched_step,
                                                 make_scenario_batch,
                                                 make_sim_mesh)
    from benchmarks import matrix

    seen = []
    call = pallas_kernels._local_hyper_call

    def spy(dix, *a, **kw):
        seen.append(dix.shape)
        return call(dix, *a, **kw)

    solver = matrix._beam_solver(7, 3, 3, "nh", 3, pcg=("jacobi", 30, 1e-6))
    batch = make_scenario_batch(solver, 1)
    mesh = make_sim_mesh(n_scene=1, n_shard=4, devices=jax.devices()[:4])
    pallas_kernels._local_hyper_call = spy
    try:
        out = make_batched_step(solver, mesh=mesh, donate=False)(batch)
        (_, local), = set(seen)
        seen.clear()
        one = make_batched_step(solver, mesh=None, donate=False)(batch)
        (_, full), = set(seen)
    finally:
        pallas_kernels._local_hyper_call = call
    assert full % 4 and local == -(-full // 4), (local, full)
    x, x1 = np.asarray(out.x), np.asarray(one.x)
    assert np.abs(x - x1).max() < 1e-4 * np.abs(x1).max()


@pytest.mark.gpu
def test_kernel_matches_jnp_on_gpu(gpu_device):
    """The compiled Triton kernel and XLA's GPU build of the jnp body,
    each against the CPU build of the jnp body, on inverted and
    3x-stretched random F where the f32 prox is ill-conditioned
    (chip_smoke.py's kernels phase runs the same check). The bound,
    chip_smoke.HARD_INPUT_BOUND, is set from the XLA-vs-CPU reading."""
    import chip_smoke

    pallas_kernels.set_pallas_mode("auto")
    for rec in chip_smoke.hard_input_check():
        assert rec["kernel_vs_cpu"] < chip_smoke.HARD_INPUT_BOUND, rec
