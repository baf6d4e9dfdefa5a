"""The three local-step paths on the GPU, end to end and alone.

For each scene, compiles the solver's fused rollout with the plain-jnp
body fused by XLA ("jnp", set_svd_impl("jacobi")) and with the automatic
GPU f32 choice, the Pallas kernel ("triton"), then times the compiled
rollouts in turns (a, b, b, a, ... for --reps rounds) so that drift on
the card shows up as a spread. The isolated local step of the scene's
tet family is timed the same way for all three implementations, called
directly: "lapack" (AoS + cuSOLVER SVD), "jnp" and "triton". Prints the
card's nvidia-smi line, one JSON line per (scene, path), and the
kernel's block/warp sweep, each with the device.

--ptx also dumps the kernel's PTX, counts its f32 division and square
root instructions by rounding (approximate or round-to-nearest) and
prints ptxas's register and spill report.

Run on a machine with a GPU:
  python benchmarks/local_step.py [--scenes beam-nh-5k,beam-nh-500k] [--ptx]
"""

import argparse
import glob
import json
import os
import re
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

E2E = {"jnp": "jacobi", "triton": "auto"}  # path -> set_svd_impl value
SWEEP = ((64, 2), (128, 4), (256, 4), (256, 8), (512, 8))
PTX_PATTERNS = ("div.full.f32", "div.approx", "div.rn.f32", "sqrt.approx",
                "sqrt.rn.f32", "rsqrt.approx", "ex2.approx", "lg2.approx")


def _local_lapack(b, d, u):
    from admm_elastic_tpu.ops import prox as prox_ops

    v = d + u
    z = prox_ops.prox_tet_hyper(v.T.reshape(-1, 3, 3), b.model, b.mu, b.lam,
                                b.kappa, b.bulk).reshape(-1, 9).T
    return z, v - z


def _local_jnp(b, d, u):
    import jax.numpy as jnp

    from admm_elastic_tpu.ops import hyper_soa

    v = d + u
    z = jnp.stack(hyper_soa.prox_tet_hyper_tuple(
        tuple(v[i] for i in range(9)), b.model, b.mu, b.lam, b.kappa,
        b.bulk))
    return z, v - z


def _local_triton(b, d, u):
    from admm_elastic_tpu.ops import pallas_kernels as pk

    return pk.local_step_tet_hyper_pallas(d, u, b.model, b.mu, b.lam,
                                          b.kappa, b.bulk)


LOCAL = {"lapack": _local_lapack, "jnp": _local_jnp,
         "triton": _local_triton}


def _run_args(solver, n_steps):
    import jax.numpy as jnp

    s = solver.m_settings
    args = (solver.system, solver._solve_data, tuple(solver.obstacles),
            tuple(solver.colliders), tuple(solver.ext_forces),
            solver._surf_inds_dev, solver._pin_mask, solver._pin_target,
            solver.state, solver._params(), jnp.asarray(n_steps, jnp.int32))
    static = dict(linsolver=s.linsolver, prox_iters=s.prox_newton_iters,
                  with_passive=True, refine_passes=solver._refine_eff,
                  unroll_admm_iters=(s.admm_iters if s.unroll_admm else 0),
                  aa_window=s.aa_window, dense_surf=solver._surf_dense)
    return args, static


def compile_rollout(path, solver):
    """The solver's fused rollout traced on `path`, and its compile s."""
    import jax
    import jax.numpy as jnp

    from admm_elastic_tpu import solver as solver_mod
    from admm_elastic_tpu.ops import prox as prox_ops
    from admm_elastic_tpu.system import elements as el

    prox_ops.set_svd_impl(E2E[path])
    try:
        assert el.local_step_path(jax.default_backend(), jnp.float32) == path
        jax.clear_caches()  # the path is read at trace time
        args, static = _run_args(solver, 1)
        t0 = time.perf_counter()
        exe = solver_mod._run_impl.lower(*args, **static).compile()
    finally:
        prox_ops.set_svd_impl("auto")
    return exe, time.perf_counter() - t0


def _timed(fn, *args):
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    return time.perf_counter() - t0


def _interleaved(fns, args, reps, inner=1):
    """Best-of-`inner` wall of each fn, in turns a, b, c, c, b, a, ..."""
    names = list(fns)
    for n in names:  # first execution of each executable
        _timed(fns[n], *args)
    walls = {n: [] for n in names}
    for r in range(reps):
        for n in (names if r % 2 == 0 else names[::-1]):
            walls[n].append(min(_timed(fns[n], *args) for _ in range(inner)))
    return walls


def measure_scene(label, steps, reps):
    """Per-step rollout time (E2E paths) and isolated local-step time
    (LOCAL paths) of one matrix.py scene, one record per path."""
    import jax
    import jax.numpy as jnp

    from admm_elastic_tpu.system import system as sysm
    from benchmarks import matrix

    solver = matrix.SCENES[label]()
    rng = np.random.default_rng(0)
    x0 = np.asarray(solver.state.x)
    x = jnp.asarray(x0 + 0.05 * rng.standard_normal(x0.shape), jnp.float32)
    dix = jax.jit(lambda s, xx: sysm.Dx(s, xx)[0])(solver.system, x)
    u = jnp.zeros_like(dix)
    fam = solver.system.tets[0]
    recs = {p: {"scene": label, "path": p, "elements": int(fam.n)}
            for p in LOCAL}
    local = {}
    for p, fn in LOCAL.items():
        t0 = time.perf_counter()
        local[p] = jax.jit(fn).lower(fam, dix, u).compile()
        recs[p]["local_compile_s"] = time.perf_counter() - t0
    walls = _interleaved(local, (fam, dix, u), reps, inner=20)
    for p in LOCAL:
        recs[p]["local_step_ms_best"] = min(walls[p]) * 1e3
        recs[p]["local_step_ms_all"] = [w * 1e3 for w in walls[p]]
    runs = {}
    for p in E2E:
        runs[p], recs[p]["rollout_compile_s"] = compile_rollout(p, solver)
    args, _ = _run_args(solver, steps)
    walls = _interleaved(runs, args, reps)
    for p in E2E:
        recs[p]["step_ms_best"] = min(walls[p]) * 1e3 / steps
        recs[p]["step_ms_all"] = [w * 1e3 / steps for w in walls[p]]
    return list(recs.values()), fam, dix, u


def _sweep_call(fam, dix, u, block, warps):
    from admm_elastic_tpu.ops import pallas_kernels as pk

    return pk._local_hyper_call(
        dix, u, fam.mu, fam.lam, fam.kappa, fam.bulk, model=fam.model,
        n_iters=8, sweeps=8, block=block, num_warps=warps, interpret=False)


def kernel_sweep(fam, dix, u, reps=20):
    """Isolated kernel time for each (block, num_warps) of SWEEP."""
    import jax

    out = []
    for block, warps in SWEEP:
        fn = jax.jit(lambda b, d, uu: _sweep_call(b, d, uu, block, warps))
        compile_s = _timed(fn, fam, dix, u)
        best = min(_timed(fn, fam, dix, u) for _ in range(reps))
        out.append({"block": block, "num_warps": warps,
                    "first_call_s": compile_s,
                    "local_step_ms_best": best * 1e3})
    return out


def ptx_report(dump_dir, fam, dix, u):
    """Compile the kernel as its own module for each hyperelastic model
    and read the PTX that XLA dumped for it."""
    import dataclasses

    import jax

    from admm_elastic_tpu.ops import pallas_kernels as pk

    for model in ("neohookean", "stvk"):
        jax.block_until_ready(_sweep_call(
            dataclasses.replace(fam, model=model), dix, u, pk.BLOCK,
            pk.NUM_WARPS))
    ptxas = "/usr/local/cuda/bin/ptxas"
    out = []
    for path in sorted(glob.glob(os.path.join(dump_dir, "*.ptx"))):
        text = open(path).read()
        if "local_step_tet_hyper" not in text:
            continue
        rec = {"ptx": os.path.basename(path),
               "counts": {p: text.count(p) for p in PTX_PATTERNS}}
        if os.path.exists(ptxas):
            arch = re.search(r"^\.target\s+(\w+)", text, re.M).group(1)
            res = subprocess.run(
                [ptxas, "-v", f"--gpu-name={arch}", path, "-o", os.devnull],
                capture_output=True, text=True)
            rec["ptxas"] = [ln.strip() for ln in res.stderr.splitlines()
                            if "registers" in ln or "spill" in ln]
        out.append(rec)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenes", default="beam-nh-5k,beam-nh-500k")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--ptx", action="store_true",
                    help="report the kernel's PTX rounding and registers")
    args = ap.parse_args()

    dump_dir = None
    if args.ptx:  # read when the backend starts
        dump_dir = tempfile.mkdtemp(prefix="local_step_ptx_")
        os.environ["XLA_FLAGS"] = " ".join(filter(None, (
            os.environ.get("XLA_FLAGS"), f"--xla_dump_to={dump_dir}",
            "--xla_dump_hlo_module_re=.*local_hyper_call.*")))

    import jax

    from admm_elastic_tpu.utils.device import require_gpu, setup_compile_cache

    setup_compile_cache()
    if dump_dir:  # a cached executable would be loaded, not compiled
        jax.config.update("jax_enable_compilation_cache", False)
    device = require_gpu()
    print(device["nvidia_smi"], flush=True)
    print(json.dumps({"device": device}), flush=True)
    for i, label in enumerate(args.scenes.split(",")):
        recs, fam, dix, u = measure_scene(label, args.steps, args.reps)
        for rec in recs:
            print(json.dumps({**rec, "device": device}), flush=True)
        print(json.dumps({"scene": label, "kernel_sweep":
                          kernel_sweep(fam, dix, u), "device": device}),
              flush=True)
        if dump_dir and i == 0:
            for rec in ptx_report(dump_dir, fam, dix, u):
                print(json.dumps({**rec, "device": device}), flush=True)


if __name__ == "__main__":
    main()
