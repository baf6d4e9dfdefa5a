"""Scaling measurements: scenario-batch throughput + weak scaling.

Two experiments, per the BASELINE.json north star (scenario sweeps + >=70%
weak-scaling efficiency):

1. ``--throughput`` (default; needs a GPU): total ADMM iterations/s
   across a batch of S independent beam scenes for S in 1..max. Shows how
   far one card is from saturation.

2. ``--weak`` (forces JAX_PLATFORMS=cpu with 8 virtual devices): fixed
   scenes-per-device, device count 1/2/4/8 on a ("scene","shard") mesh;
   reports efficiency = T1 / TD (perfect = 1.0). Virtual CPU devices
   share the host's cores, so this validates the *sharding program*
   (GSPMD partitioning + collectives), not real-chip speedup; run on a
   real multi-chip slice the same script measures the true number.

Writes JSON lines to stdout and (with --out) a JSON file.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

NX, NY, NZ = 40, 5, 5  # the bench.py beam: 5000 tets / 1476 verts
ADMM_ITERS = 10
STEPS = 10


def _build_solver(np, dtype):
    from admm_elastic_tpu import Lame, Settings, Solver, binding
    from admm_elastic_tpu.geometry.factory import make_tet_blocks

    mesh = make_tet_blocks(NX, NY, NZ)
    mesh.flags = binding.NOSELFCOLLISION | binding.NEOHOOKEAN
    solver = Solver()
    binding.add_tetmesh(solver, mesh, Lame.soft_rubber(), verbose=False)
    pins = [int(i) for i in np.where(mesh.vertices[:, 0] < 1e-9)[0]]
    solver.set_pins(pins)
    st = Settings(verbose=0, admm_iters=ADMM_ITERS, linsolver=3, gravity=-9.8,
                  dtype=dtype, pcg_max_iters=40, pcg_tol=1e-6)
    assert solver.initialize(st)
    return solver


def _time_batch(jax, step, batch, reps=3):
    """s/step for the whole batch; `batch` may be a ScenarioBatch or a
    list of them (chunked dispatch — each chunk steps through the same
    compiled executable, dispatches pipeline)."""
    def once(b):
        if isinstance(b, list):
            return [step(c) for c in b]
        return step(b)

    def block(b):
        for c in (b if isinstance(b, list) else [b]):
            jax.block_until_ready(c.x)

    batch = once(batch)
    block(batch)
    best = 1e9
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(STEPS):
            batch = once(batch)
        block(batch)
        best = min(best, time.perf_counter() - t0)
    return best / STEPS


def run_throughput(max_scenes: int, chunk: int = 0):
    import numpy as np
    import jax
    import jax.numpy as jnp

    from admm_elastic_tpu.parallel import batch as pb

    solver = _build_solver(np, np.float32)
    results = []
    step_c = None
    s = 1
    while s <= max_scenes:
        # Uniform stiffness isolates the batching amplification (a vmapped
        # PCG while_loop runs to the slowest scene's iteration count, so a
        # stiffness sweep would conflate physics with utilization).
        if chunk and s > chunk:
            # Chunked dispatch: S scenes as
            # S/chunk independent chunk-sized programs. Decouples the
            # vmapped while-loop's max-iteration coupling across chunks,
            # keeps the per-dispatch working set flat, and reuses ONE
            # compiled executable across every S.
            assert s % chunk == 0
            bt = [pb.make_scenario_batch(solver, chunk,
                                         stiffness_scale=np.ones(chunk),
                                         jitter=0.01, seed=i)
                  for i in range(s // chunk)]
            if step_c is None:
                step_c = pb.make_batched_step(solver, mesh=None)
            step = step_c
        else:
            bt = pb.make_scenario_batch(solver, s, stiffness_scale=np.ones(s),
                                        jitter=0.01)
            step = pb.make_batched_step(solver, mesh=None)
        dt = _time_batch(jax, step, bt)
        iters = s * ADMM_ITERS / dt
        rec = {"scenes": s, "ms_per_step": dt * 1e3,
               "total_admm_iters_per_s": iters}
        if chunk and s > chunk:
            rec["chunk"] = chunk
        results.append(rec)
        print(json.dumps(results[-1]))
        s *= 2
    base = results[0]["total_admm_iters_per_s"]
    print(json.dumps({
        "metric": "scenario-batch throughput amplification",
        "value": round(results[-1]["total_admm_iters_per_s"] / base, 2),
        "unit": f"x over single scene at S={results[-1]['scenes']}",
    }))
    return results


def run_weak(scenes_per_device: int):
    import numpy as np
    import jax
    from jax.sharding import Mesh

    from admm_elastic_tpu.parallel import batch as pb

    devs = jax.devices()
    solver = _build_solver(np, np.float32)
    results = []
    t1 = None
    d = 1
    while d <= len(devs):
        s = scenes_per_device * d
        mesh = Mesh(np.asarray(devs[:d]).reshape(d, 1), axis_names=("scene", "shard"))
        bt = pb.make_scenario_batch(solver, s, stiffness_scale=np.ones(s), jitter=0.01)
        step = pb.make_batched_step(solver, mesh=mesh)
        dt = _time_batch(jax, step, bt, reps=2)
        if t1 is None:
            t1 = dt
        # On virtual devices sharing this host's core(s), wall-clock cannot
        # improve with D; what must hold is that the *partitioned program
        # does no redundant work*: T_D ~= T_1 * D on one core. overhead =
        # T_D / (T_1 * D); ~1.0 = GSPMD partitioning is work-conserving,
        # which is the single-host proxy for real-chip weak efficiency.
        results.append({
            "devices": d, "scenes": s, "ms_per_step": round(dt * 1e3, 2),
            "wallclock_ratio_vs_1dev": round(t1 / dt, 3),
            "partition_overhead": round(dt / (t1 * d), 3),
        })
        print(json.dumps(results[-1]))
        d *= 2
    return results


def run_bigmesh():
    """Single large mesh (160k tets), ELL-PCG global solver: the regime
    the matrix-free/ELL design targets (a dense inverse would need 5 GB).
    """
    import numpy as np
    import jax

    from admm_elastic_tpu import Lame, Settings, Solver, binding
    from admm_elastic_tpu.geometry.factory import make_tet_blocks

    mesh = make_tet_blocks(80, 20, 20)  # 160k tets / 35721 verts
    mesh.flags = binding.NOSELFCOLLISION | binding.NEOHOOKEAN
    solver = Solver()
    binding.add_tetmesh(solver, mesh, Lame.soft_rubber(), verbose=False)
    pins = [int(i) for i in np.where(mesh.vertices[:, 0] < 1e-9)[0]]
    solver.set_pins(pins)
    st = Settings(verbose=0, admm_iters=ADMM_ITERS, linsolver=3, gravity=-9.8,
                  dtype=np.float32, pcg_max_iters=60, pcg_tol=1e-6)
    assert solver.initialize(st)
    solver.run(1)
    jax.block_until_ready(solver.state.x)
    best = 1e9
    for _ in range(3):
        t0 = time.perf_counter()
        solver.run(STEPS)
        jax.block_until_ready(solver.state.x)
        best = min(best, time.perf_counter() - t0)
    dt = best / STEPS
    res = {"tets": 160000, "verts": 35721, "ms_per_step": dt * 1e3,
           "admm_iters_per_s": ADMM_ITERS / dt,
           "tet_prox_per_s_millions": 160000 * ADMM_ITERS / dt / 1e6}
    print(json.dumps(res))
    return res


def run_bigcontact(nx=60, ny=15, nz=15):
    """Hard-contact Uzawa at scale: a large beam dropped
    on the floor with linsolver=2 and the sparse ELL-PCG inner operator —
    the regime where the dense N x N inverse cannot exist (15.6k verts =
    1.9 GB f64 dense; the ELL form is ~60 entries/row). Matches the
    reference's UzawaCG-over-SimplicialLDLT scaling story
    (src/UzawaCG.hpp:92-120, src/LinearSolver.hpp:79-84).
    """
    import numpy as np
    import jax
    import jax.numpy as jnp

    from admm_elastic_tpu import Floor, Lame, Settings, Solver, binding
    from admm_elastic_tpu.geometry.factory import make_tet_blocks, make_xform
    from admm_elastic_tpu.solvers.pcg import PCGData

    n_tets = 5 * nx * ny * nz
    mesh = make_tet_blocks(nx, ny, nz, cell=0.1)
    mesh.flags = binding.NOSELFCOLLISION | binding.LINEAR
    mesh.apply_xform(make_xform(trans=(0.0, 0.5, 0.0)))
    solver = Solver()
    binding.add_tetmesh(solver, mesh, Lame.soft_rubber(), verbose=False)
    solver.add_obstacle(Floor(y=jnp.asarray(0.0)))
    st = Settings(verbose=0, admm_iters=ADMM_ITERS, linsolver=2,
                  dtype=np.float32, uzawa_max_iters=10,
                  uzawa_inner_tol=1e-5, uzawa_inner_iters=60)
    assert solver.initialize(st)
    assert isinstance(solver._solve_data, PCGData), "expected sparse inner"
    ell_mb = (solver._solve_data.ell_vals.size * 8) / 1e6  # i32 cols + f32 vals
    solver.run(1)
    jax.block_until_ready(solver.state.x)
    best = 1e9
    for _ in range(3):
        t0 = time.perf_counter()
        solver.run(STEPS)
        jax.block_until_ready(solver.state.x)
        best = min(best, time.perf_counter() - t0)
    dt = best / STEPS
    x = np.asarray(solver.state.x)
    assert np.isfinite(x).all()
    # 30 more steps to reach/hold contact, then check that the body did
    # not pass through the floor.
    solver.run(30)
    x = np.asarray(solver.state.x)
    assert np.isfinite(x).all()
    miny = float(x[:, 1].min())
    assert miny > -0.10, f"passed through the floor: min y {miny}"
    res = {"scene": "beam-drop-uzawa-sparse", "tets": n_tets,
           "verts": int(x.shape[0]), "ms_per_step": dt * 1e3,
           "admm_iters_per_s": ADMM_ITERS / dt,
           "ell_operator_mb": ell_mb, "final_min_y": miny}
    print(json.dumps(res))
    return res


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--weak", action="store_true")
    ap.add_argument("--bigmesh", action="store_true")
    ap.add_argument("--bigcontact", action="store_true")
    ap.add_argument("--max-scenes", type=int, default=64)
    ap.add_argument("--chunk", type=int, default=0,
                    help="dispatch batches larger than this as independent "
                         "chunk-sized programs (0 = single dispatch)")
    ap.add_argument("--scenes-per-device", type=int, default=2)
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args()

    if args.weak:
        # Its purpose is the CPU: 8 virtual devices validate the sharding
        # program (see the module docstring).
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8"
            ).strip()
        import jax

        jax.config.update("jax_platforms", "cpu")
        res = {"weak_scaling": run_weak(args.scenes_per_device),
               "device": {"platform": "cpu", "kind": "virtual",
                          "count": len(jax.devices())}}
    else:
        from admm_elastic_tpu.utils.device import (require_gpu,
                                                   setup_compile_cache)

        setup_compile_cache()
        device = require_gpu()
        print(json.dumps({"device": device}), flush=True)
        if args.bigmesh:
            res = {"bigmesh": run_bigmesh()}
        elif args.bigcontact:
            res = {"bigcontact": run_bigcontact()}
        else:
            res = {"throughput": run_throughput(args.max_scenes,
                                                chunk=args.chunk)}
        res["device"] = device
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
