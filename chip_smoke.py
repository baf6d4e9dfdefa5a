#!/usr/bin/env python3
"""On-card smoke test of the ADMM elastodynamics step.

  python chip_smoke.py               one GPU: device, kernels, scenes, crossval
  python chip_smoke.py --four-cards  four GPUs: the sharded multi-device path
                                     (parallel/batch.py) and the one-card
                                     rollouts it is compared with, only

Each phase prints one JSON line with its wall time. The last line of
standard output is {"ok": true, "device": {"platform", "kind", "count"}}.
A failing phase, a missing GPU, or a checkout without the package ends
the run with a non-zero exit code and no result line. The scenes are the
builders of benchmarks/matrix.py at their full sizes; data is made from
--seed. One process drives the card(s); the crossval CPU reference runs
in a child with JAX_PLATFORMS=cpu, so it never opens a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

# beam-nh-500k local step, GPU f32 vs the f64 CPU reference (ops/prox.py
# with the LAPACK SVD), max error over the max element value. The f32
# Newton stops at a gradient/step tolerance, so f32 paths sit ~1e-4 from
# the f64 answer (CPU f32 at a 10x3x3 beam: LAPACK path 7.0e-5); 1e-3
# leaves room for that and catches a wrong kernel (O(1) errors or NaN).
LOCAL_STEP_BOUND = 1e-3
# The Pallas kernel against XLA's build of the same jnp body on the card:
# identical math, different compilers (reassociation, loop form vs
# unrolled); each stops within the Newton tolerance of the answer, so the bound is
# the f64 one.
KERNEL_VS_JNP_BOUND = LOCAL_STEP_BOUND
# The kernel, XLA's GPU build of the jnp body and the CPU's build of it on
# inverted and 3x-stretched random F, where the f32 prox is
# ill-conditioned. On an H100 XLA-vs-CPU reads 1.3e-4 (NH) and 1.9e-4
# (StVK), the kernel 3.6e-4 and 1.9e-4; 1e-3 is ~5x the XLA reading.
HARD_INPUT_BOUND = 1e-3
# direct.solve inverse apply (beam-nh-5k, inv mode) against an f64 solve:
# the one-apply error bound the inv-mode tier was proven at.
DIRECT_APPLY_BOUND = 1.1e-5
# Four-card rollouts against the same rollout on one card.
SHARD_AGREE_BOUND = 1e-3


def select_phases(argv):
    """Phase names for a command line (no arguments: the one-card phases)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card sharded path")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.four_cards:
        return ["device", "four_cards"], args
    return ["device", "kernels", "scenes", "crossval"], args


def _emit(phase, t0, **rec):
    print(json.dumps({"phase": phase, "ok": True,
                      "wall_s": time.perf_counter() - t0, **rec}),
          flush=True)


# ---------------------------------------------------------------------------
# device
# ---------------------------------------------------------------------------

def phase_device(n_cards):
    import jax

    from admm_elastic_tpu.utils.device import require_gpu, setup_compile_cache

    t0 = time.perf_counter()
    cache = setup_compile_cache()
    dev = require_gpu()
    if dev["count"] < n_cards:
        raise SystemExit(f"need {n_cards} GPUs, JAX found {dev['count']}")
    print(dev["nvidia_smi"], flush=True)
    _emit("device", t0, device=dev, compile_cache=cache,
          jax=jax.__version__)
    return {k: dev[k] for k in ("platform", "kind", "count")}


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def local_step_check(solver, seed):
    """Each hyperelastic model's local step on the solver's first tet
    family: the GPU path vs the f64 CPU reference, and (where the path is
    the Pallas kernel) the kernel vs XLA's build of the jnp body."""
    import jax
    import jax.numpy as jnp

    from admm_elastic_tpu.ops import hyper_soa
    from admm_elastic_tpu.ops import prox as prox_ops
    from admm_elastic_tpu.system import elements as el
    from admm_elastic_tpu.system import system as sysm

    rng = np.random.default_rng(seed)
    x0 = np.asarray(solver.state.x, np.float64)
    x = x0 * np.array([1.1, 0.95, 1.0]) + 0.05 * rng.standard_normal(x0.shape)
    fam = solver.system.tets[0]
    dix = jax.jit(lambda s, xx: sysm.Dx(s, xx)[0])(
        solver.system, jnp.asarray(x, jnp.float32))
    u = jnp.asarray(0.01 * rng.standard_normal(dix.shape), jnp.float32)
    path = el.local_step_path(jax.default_backend(), jnp.float32)
    cpu = jax.devices("cpu")[0]
    out = []
    for model in (prox_ops.TET_NEOHOOKEAN, prox_ops.TET_STVK):
        b = dataclasses.replace(fam, model=model)
        z, un = jax.jit(lambda bb, d, uu: bb.local_step_rows(d, uu))(b, dix, u)
        v64 = np.asarray(dix, np.float64) + np.asarray(u, np.float64)
        p64 = [np.asarray(a, np.float64) for a in (b.mu, b.lam, b.kappa)]
        with jax.enable_x64(True), jax.default_device(cpu):
            mu, lam, kap = (jnp.asarray(a) for a in p64)
            zr = jax.jit(prox_ops.prox_tet_hyper, static_argnums=(1,))(
                jnp.asarray(v64.T.reshape(-1, 3, 3)), model, mu, lam, kap,
                lam + (2.0 / 3.0) * mu)
            z_ref = np.asarray(zr).reshape(-1, 9).T
        rec = {"model": model, "path": path, "elements": int(b.n),
               "rel_err_vs_f64": _rel(z, z_ref),
               # u' = v - z: its error is z's, on z's scale.
               "dual_rel_err_vs_f64": _rel(un, v64 - z_ref) * np.abs(
                   v64 - z_ref).max() / np.abs(z_ref).max(),
               "bound": LOCAL_STEP_BOUND}
        assert rec["rel_err_vs_f64"] < LOCAL_STEP_BOUND, rec
        assert rec["dual_rel_err_vs_f64"] < LOCAL_STEP_BOUND, rec
        if path == "triton":
            zj = jax.jit(lambda bb, vv: jnp.stack(hyper_soa.prox_tet_hyper_tuple(
                tuple(vv[i] for i in range(9)), bb.model, bb.mu, bb.lam,
                bb.kappa, bb.bulk)))(b, dix + u)
            rec["kernel_rel_err_vs_jnp"] = _rel(z, zj)
            rec["kernel_bound"] = KERNEL_VS_JNP_BOUND
            assert rec["kernel_rel_err_vs_jnp"] < KERNEL_VS_JNP_BOUND, rec
        out.append(rec)
    return out


def hard_inputs(t=1500, seed=3):
    """Mixed near-identity, inverted and stretched F rows [9, t] and NH
    material parameters, in f32 (as tests/test_pallas.py builds them)."""
    rng = np.random.default_rng(seed)
    f = np.eye(3)[None] + 0.4 * rng.standard_normal((t, 3, 3))
    f[::5] *= -1.0
    f[1::7] *= 3.0
    mu = rng.uniform(1e4, 1e6, t)
    lam = rng.uniform(1e4, 1e6, t)
    return [np.asarray(a, np.float32) for a in (
        f.reshape(t, 9).T, mu, lam, np.zeros(t), lam + (2.0 / 3.0) * mu)]


def hard_input_check():
    """The kernel and XLA's GPU build of the jnp body, each against the
    CPU build of the jnp body, on hard_inputs()."""
    import jax
    import jax.numpy as jnp

    from admm_elastic_tpu.ops import hyper_soa, pallas_kernels
    from admm_elastic_tpu.ops import prox as prox_ops

    rows, mu, lam, kappa, k = hard_inputs()
    zero = np.zeros_like(rows)
    cpu = jax.devices("cpu")[0]
    out = []
    for model in (prox_ops.TET_NEOHOOKEAN, prox_ops.TET_STVK):
        def body(v, mu, lam, kappa, k, model=model):
            return jnp.stack(hyper_soa.prox_tet_hyper_tuple(
                tuple(v[i] for i in range(9)), model, mu, lam, kappa, k))

        z_kernel, _ = jax.jit(
            lambda *a, model=model: pallas_kernels.local_step_tet_hyper_pallas(
                a[0], a[1], model, *a[2:]))(rows, zero, mu, lam, kappa, k)
        z_xla = jax.jit(body)(rows, mu, lam, kappa, k)
        with jax.default_device(cpu):
            z_cpu = jax.jit(body)(*(jax.device_put(a, cpu) for a in (
                rows, mu, lam, kappa, k)))
        rec = {"model": model, "elements": int(rows.shape[1]),
               "kernel_vs_cpu": _rel(z_kernel, z_cpu),
               "xla_vs_cpu": _rel(z_xla, z_cpu),
               "kernel_vs_xla": _rel(z_kernel, z_xla),
               "bound": HARD_INPUT_BOUND}
        assert np.isfinite(np.asarray(z_kernel)).all(), rec
        assert rec["kernel_vs_cpu"] < HARD_INPUT_BOUND, rec
        assert rec["xla_vs_cpu"] < HARD_INPUT_BOUND, rec
        out.append(rec)
    return out


def direct_apply_check(solver, seed):
    """One inverse apply of the inv-mode direct solve at each f32 matmul
    tier against an f64 host solve of the same system."""
    import jax
    import jax.numpy as jnp

    from admm_elastic_tpu.solvers import direct as direct_mod
    from admm_elastic_tpu.system import assembly

    data = solver._solve_data
    assert isinstance(data, direct_mod.DirectData) and data.mode == "inv"
    a = assembly.assemble_dense(solver.system)
    b = np.random.default_rng(seed).standard_normal((a.shape[0], 3))
    x_ref = np.linalg.solve(a, b)
    bd = jnp.asarray(b, jnp.float32)

    def apply(prec):
        return jax.jit(lambda d, r: d.scale * jnp.matmul(
            d.mat, d.scale * r, precision=prec))(data, bd)

    def err(x):
        x = np.asarray(x, np.float64)
        return float(np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref))

    rec = {"n": int(a.shape[0]), "bound": DIRECT_APPLY_BOUND,
           "rel_err_solve": err(direct_mod.solve(data, bd)),
           "rel_err_highest": err(apply(jax.lax.Precision.HIGHEST)),
           "rel_err_high": err(apply(jax.lax.Precision.HIGH)),
           "rel_err_default": err(apply(jax.lax.Precision.DEFAULT))}
    assert rec["rel_err_solve"] < DIRECT_APPLY_BOUND, rec
    return rec


def phase_kernels(solvers, seed):
    t0 = time.perf_counter()
    local = local_step_check(solvers["beam-nh-500k"], seed)
    hard = hard_input_check()
    direct = direct_apply_check(solvers["beam-nh-5k"], seed)
    _emit("kernels", t0, local_step=local, hard_inputs=hard,
          direct_apply=direct)


# ---------------------------------------------------------------------------
# scenes
# ---------------------------------------------------------------------------

# label -> (settle steps, checked steps, floor y or None)
SCENES = {
    "beam-nh-5k": (0, 5, None),
    "beam-nh-500k": (0, 3, None),
    "beam-floor-alpcg-500k": (0, 15, -1.0),
    "cloth-limit-160": (0, 5, None),
    # The impact steps may overflow the near-lane capacity by design
    # (benchmarks/matrix.py); overflow is checked on the settled window.
    "meshobs-exact-20k": (10, 3, -0.1),
    "boxes-alpcg-n6": (0, 15, -0.5),
}
# How far below a floor the lowest vertex may sit. At matrix.py's AL-PCG
# settings (100 iterations, tol 1e-4) a heavy beam sinks in the impact
# steps and bounces back: 0.13 at 60x16x16 cells on the CPU in f32, 0.15
# at beam-floor-alpcg-500k on the GPU, both at step 15 of a 1 m drop. A
# body passing through the floor keeps falling ~0.2 per step; 0.25
# separates the two.
FLOOR_SLACK = 0.25


def check_state(label, solver, floor_y):
    x = solver.x
    assert np.isfinite(x).all(), f"{label}: non-finite state"
    pins = solver._pins
    pin_err = 0.0
    if pins:
        idx = np.fromiter(pins.keys(), int)
        tgt = np.stack([pins[i] for i in idx])
        pin_err = float(np.abs(x[idx] - tgt).max())
        assert pin_err < 1e-3, f"{label}: pins not held ({pin_err})"
    min_y = float(x[:, 1].min())
    if floor_y is not None:
        assert min_y > floor_y - FLOOR_SLACK, \
            f"{label}: passed through the floor (min y {min_y})"
    overflow = bool(solver.runtime_data().collision_overflow)
    assert not overflow, f"{label}: contact capacity overflow"
    return {"pin_err": pin_err, "min_y": min_y, "overflow": overflow}


def batched_sweep(n_scenes, steps=3):
    """make_batched_step over S pinned beams (stiffness x gravity sweep)."""
    import jax

    from admm_elastic_tpu.parallel.batch import (make_batched_step,
                                                 make_scenario_batch)
    from benchmarks import matrix

    solver = matrix._beam_solver(40, 5, 5, "nh", 3)
    batch = make_scenario_batch(
        solver, n_scenes, stiffness_scale=np.linspace(0.5, 2.0, n_scenes),
        gravity=np.linspace(-5.0, -15.0, n_scenes))
    step = make_batched_step(solver, mesh=None, donate=False)
    for _ in range(steps):
        batch = step(batch)
    x = np.asarray(jax.block_until_ready(batch.x))
    assert np.isfinite(x).all(), "batched sweep: non-finite state"
    idx = np.fromiter(solver._pins.keys(), int)
    pin_err = float(np.abs(x[:, idx] - solver.x[idx][None]).max())
    assert pin_err < 1e-3, f"batched sweep: pins not held ({pin_err})"
    assert not bool(np.asarray(batch.overflow).any())
    return {"label": f"batched-beam-nh-5k-S{n_scenes}", "scenes": n_scenes,
            "steps": steps, "pin_err": pin_err,
            "min_y": float(x[..., 1].min())}


def phase_scenes(solvers, build):
    t0 = time.perf_counter()
    recs = []
    for label, (settle, steps, floor_y) in SCENES.items():
        t1 = time.perf_counter()
        solver = solvers.pop(label, None) or build(label)
        if settle:
            solver.run(settle)
        solver.run(steps)
        rec = {"label": label, "n_verts": int(solver._n_verts),
               "steps": settle + steps,
               **check_state(label, solver, floor_y),
               "wall_s": time.perf_counter() - t1}
        recs.append(rec)
        print(json.dumps({"scene": rec}), flush=True)
    t1 = time.perf_counter()
    rec = batched_sweep(64)
    rec["wall_s"] = time.perf_counter() - t1
    recs.append(rec)
    _emit("scenes", t0, scenes=recs)


# ---------------------------------------------------------------------------
# crossval
# ---------------------------------------------------------------------------

def phase_crossval(child, out_path):
    from admm_elastic_tpu.ops import prox as prox_ops
    from benchmarks import crossval

    t0 = time.perf_counter()
    try:
        accel = {name: crossval.run_scene(**kw) for name, kw in crossval.SCENES}
    finally:
        prox_ops.set_svd_impl("auto")
    t_accel = time.perf_counter() - t0
    rc = child.wait(timeout=1200)
    assert rc == 0, f"crossval CPU reference child exited {rc}"
    cpu = dict(np.load(out_path))
    records, verdict = crossval.compare(accel, cpu)
    for rec in records:
        print(json.dumps({"crossval_scene": rec}), flush=True)
    assert verdict["crossval"] == "PASS", verdict
    _emit("crossval", t0, accel_wall_s=t_accel, **verdict)


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------

_COLLECTIVES = ("all-reduce", "all-gather", "collective-permute",
                "reduce-scatter", "all-to-all")
_TRITON_CALL = "__gpu$xla.gpu.triton"


def kernel_elems(hlo):
    """Largest element count of the first result of any Triton kernel call
    in compiled HLO text (the kernel's z rows, shaped like its D x
    operand); 0 when the step calls no Triton kernel."""
    sizes = [0]
    for line in hlo.splitlines():
        if _TRITON_CALL in line:
            m = re.search(r"=\s*\(?\w+\[([\d,]*)\]", line)
            if m:
                sizes.append(math.prod(int(d) for d in m.group(1).split(",")
                                       if d))
    return max(sizes)


def sharded_vs_one_card(solver, mesh, n_scenes, steps, **sweep):
    """Roll out make_batched_step on `mesh` and on one card; assert the
    per-device shard shapes, the collectives (none for a scene-only mesh,
    some when the vertex axis is sharded), that the local-step kernel
    runs on a per-device slice, and agreement."""
    import jax

    from admm_elastic_tpu.parallel.batch import (make_batched_step,
                                                 make_scenario_batch)

    batch = make_scenario_batch(solver, n_scenes, **sweep)
    step = make_batched_step(solver, mesh=mesh, donate=False).lower(
        batch).compile()
    one = make_batched_step(solver, mesh=None, donate=False).lower(
        batch).compile()
    n_scene_ax, n_shard = mesh.devices.shape
    hlo = step.as_text()
    found = [op for op in _COLLECTIVES if op in hlo]
    if n_shard > 1:
        assert found, "sharded step compiled without cross-device collectives"
    else:
        assert not found, f"independent scenes compiled with {found}"
    # The kernel is a custom call the partitioner cannot split: it must
    # see 1/devices of the one-card operand, not all of it.
    local, full = kernel_elems(hlo), kernel_elems(one.as_text())
    uses_kernel = jax.default_backend() == "gpu" and any(
        b.model != "linear" for b in solver.system.tets)
    assert (full > 0) == uses_kernel, f"kernel calls in one-card HLO: {full}"
    n_dev = n_scene_ax * n_shard
    assert abs(local * n_dev - full) <= 0.01 * full, \
        f"kernel operand per device {local}, one card {full}"
    out = batch
    for _ in range(steps):
        out = step(out)
    out = jax.block_until_ready(out)
    n = solver._n_verts
    shapes = {s.data.shape for s in out.x.addressable_shards}
    want = {(n_scenes // n_scene_ax, n // n_shard, 3)}
    assert shapes == want, f"shard shapes {shapes}, expected {want}"
    ref = make_scenario_batch(solver, n_scenes, **sweep)
    for _ in range(steps):
        ref = one(ref)
    x = np.asarray(out.x)
    err = _rel(x, np.asarray(ref.x))
    assert np.isfinite(x).all()
    assert not bool(np.asarray(out.overflow).any())
    assert err < SHARD_AGREE_BOUND, f"sharded vs one card: {err}"
    return {"mesh": dict(zip(mesh.axis_names, mesh.devices.shape)),
            "scenes": n_scenes, "n_verts": n, "steps": steps,
            "shard_shape": list(next(iter(shapes))), "collectives": found,
            "kernel_elems_per_device": local, "kernel_elems_one_card": full,
            "rel_err_vs_one_card": err, "bound": SHARD_AGREE_BOUND,
            "min_y": float(x[..., 1].min())}


def four_card_cases(devices, beam_cells=(79, 20, 20), sweep_cells=(40, 5, 5),
                    sweep_scenes=8, steps=2):
    """(name, solver factory, mesh, scenes, sweep kwargs) for four cards.

    The shard cases use 79x20x20 cells (158k tets): the 80x20x20 rows of
    benchmarks/matrix.py have 35721 vertices, which four cards cannot
    split evenly."""
    from admm_elastic_tpu.parallel.batch import make_sim_mesh
    from benchmarks import matrix

    nx, ny, nz = beam_cells
    scene_mesh = make_sim_mesh(n_scene=4, n_shard=1, devices=devices)
    shard_mesh = make_sim_mesh(n_scene=1, n_shard=4, devices=devices)
    sweep = dict(stiffness_scale=np.linspace(0.5, 2.0, sweep_scenes),
                 gravity=np.linspace(-5.0, -15.0, sweep_scenes))
    return [
        ("scene-sweep", lambda: matrix._beam_solver(*sweep_cells, "nh", 3),
         scene_mesh, sweep_scenes, sweep),
        ("shard-beam-nh-ls3",
         lambda: matrix._beam_solver(nx, ny, nz, "nh", 3,
                                     pcg=("jacobi", 120, 1e-6)),
         shard_mesh, 1, {}),
        ("shard-beam-floor-alpcg-ls4",
         lambda: matrix._beam_solver(nx, ny, nz, "linear", 4, floor_y=-1.0,
                                     pcg=("jacobi", 80, 1e-4)),
         shard_mesh, 1, {}),
    ], steps


def phase_four_cards(**sizes):
    import jax

    t0 = time.perf_counter()
    devices = jax.devices()[:4]
    cases, steps = four_card_cases(devices, **sizes)
    recs = []
    for name, factory, mesh, n_scenes, sweep in cases:
        t1 = time.perf_counter()
        rec = sharded_vs_one_card(factory(), mesh, n_scenes, steps, **sweep)
        rec.update(case=name, wall_s=time.perf_counter() - t1)
        recs.append(rec)
        print(json.dumps({"four_cards_case": rec}), flush=True)
    _emit("four_cards", t0, cases=recs)


# ---------------------------------------------------------------------------

def main(argv=None):
    phases, args = select_phases(sys.argv[1:] if argv is None else argv)
    try:
        import admm_elastic_tpu  # noqa: F401
    except ImportError as e:
        raise SystemExit(f"chip_smoke.py must run from a checkout: {e}")
    device = phase_device(4 if "four_cards" in phases else 1)

    if "four_cards" in phases:
        phase_four_cards()
    else:
        from benchmarks import crossval, matrix

        tmp = tempfile.mkdtemp(prefix="chip_smoke_")
        out_path = os.path.join(tmp, "crossval_cpu.npz")
        child = crossval.start_cpu_reference(out_path)
        try:
            solvers = {}

            for label in ("beam-nh-500k", "beam-nh-5k"):
                solvers[label] = matrix.SCENES[label]()
            phase_kernels(solvers, args.seed)
            phase_scenes(solvers, lambda label: matrix.SCENES[label]())
            solvers.clear()
            phase_crossval(child, out_path)
        finally:
            if child.poll() is None:
                child.kill()
                child.wait()
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
