"""Benchmark: ADMM iterations/s on the beam scene (BASELINE.json metric).

Runs the neo-Hookean tet beam (5k tets) on the GPU in f32 and prints ONE
JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "device": {...}}

vs_baseline divides by the reference C++ build's number on a host CPU,
recorded in benchmarks/BASELINE_MEASURED.json (produced by
benchmarks/run_baseline.sh, which builds the unmodified reference sources
with shim headers and runs the identical scene). Fails when JAX finds no
GPU.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

NX, NY, NZ = 40, 5, 5  # 5000 tets, 1476 verts
ADMM_ITERS = 10
N_STEPS = 200  # steps per timed rollout (one dispatch)
REPS = 5


def _timed(solver, n_steps):
    import jax

    t0 = time.perf_counter()
    solver.run(n_steps)
    jax.block_until_ready(solver.state.x)
    return time.perf_counter() - t0


def _contact_sanity():
    """Tiny floor-contact scene on the benchmarked device: guards against
    contact miscompiles (bodies passing through the floor) that the CPU
    test suite cannot see."""
    import jax.numpy as jnp

    from admm_elastic_tpu import Lame, Settings, Solver, binding
    from admm_elastic_tpu.collision.passive import Floor
    from admm_elastic_tpu.geometry.factory import make_tet_blocks

    # 20 steps reach the floor (~11 steps of freefall) and hold.
    for ls in (1, 2, 4):
        mesh = make_tet_blocks(4, 2, 2)
        mesh.flags = binding.NOSELFCOLLISION | binding.LINEAR
        s = Solver()
        binding.add_tetmesh(s, mesh, Lame.soft_rubber(), verbose=False)
        s.add_obstacle(Floor(y=jnp.asarray(-1.0)))
        st = Settings(verbose=0, admm_iters=10, linsolver=ls,
                      gravity=-9.8, dtype=np.float32, direct_mode="inv")
        assert s.initialize(st)
        s.run(20)
        x = s.x
        assert np.isfinite(x).all(), f"ls={ls}: contact scene non-finite"
        assert x[:, 1].min() > -1.1, (
            f"ls={ls}: passed through the floor (min y {x[:, 1].min()})"
        )


def main():
    from admm_elastic_tpu import Lame, Settings, Solver, binding
    from admm_elastic_tpu.geometry.factory import make_tet_blocks
    from admm_elastic_tpu.utils.device import require_gpu, setup_compile_cache

    setup_compile_cache()
    device = require_gpu()

    mesh = make_tet_blocks(NX, NY, NZ)
    mesh.flags = binding.NOSELFCOLLISION | binding.NEOHOOKEAN

    solver = Solver()
    binding.add_tetmesh(solver, mesh, Lame.soft_rubber(), verbose=False)
    pins = [int(i) for i in np.where(mesh.vertices[:, 0] < 1e-9)[0]]
    solver.set_pins(pins)

    settings = Settings(
        verbose=0,
        admm_iters=ADMM_ITERS,
        linsolver=0,
        gravity=-9.8,
        dtype=np.float32,
        direct_mode="inv",
    )
    assert solver.initialize(settings)

    # Warmup: compile the fused rollout (the step count is a traced
    # argument, so every later rollout reuses this executable).
    _timed(solver, 21)

    # Physics sanity after 21 steps: finite state, pinned face held, beam
    # sagged under gravity but did not explode.
    xs = solver.x
    assert np.isfinite(xs).all(), "non-finite state after rollout"
    assert np.abs(xs[pins] - mesh.vertices[pins]).max() < 1e-3, "pins not held"
    assert xs[:, 1].min() > -60.0 and xs[:, 1].min() < mesh.vertices[:, 1].min(), "no sag?"

    walls = [_timed(solver, N_STEPS) for _ in range(REPS)]
    assert np.isfinite(solver.x).all(), "non-finite state after timed reps"
    wall = min(walls)
    iters_per_s = N_STEPS * ADMM_ITERS / wall

    vs = None
    base_path = os.path.join(os.path.dirname(__file__), "benchmarks", "BASELINE_MEASURED.json")
    if os.path.exists(base_path):
        with open(base_path) as f:
            base = json.load(f)
        ref = base.get("admm_iters_per_s")
        if ref:
            vs = iters_per_s / ref

    _contact_sanity()

    print(json.dumps({
        "metric": "ADMM iterations/s, neo-Hookean beam 5000 tets (fp32, 1 GPU)",
        "value": iters_per_s,
        "unit": "iters/s",
        "vs_baseline": vs,
        "rollout_steps": N_STEPS,
        "walls_s": walls,
        "device": device,
    }))


if __name__ == "__main__":
    main()
