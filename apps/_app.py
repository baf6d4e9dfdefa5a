"""Headless application shell for the demo scenes.

Replaces the reference's GLFW/OpenGL Application (samples/utils/
Application.hpp) with a headless loop: frame callback -> sim callback ->
step -> optional trajectory/surface export. The reference's screenshot
pipeline (Application.hpp:254-272 + make_video.sh) maps to:
--screenshots DIR (rasterized %05d.png frames, utils/render.py) +
--video PATH (ffmpeg when present, else animated GIF), alongside the
.obj/npz dumps any offline renderer can consume.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from admm_elastic_tpu import Settings  # noqa: E402
from admm_elastic_tpu.utils.device import setup_compile_cache  # noqa: E402


def parse_cli(settings: Settings, extra=None):
    """Reference CLI flags (-dt -v -it -g -ls -ck) + app flags."""
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("-help", "--help", action="store_true", dest="show_help")
    ap.add_argument("-dt", type=float)
    ap.add_argument("-v", type=int)
    ap.add_argument("-it", type=int)
    ap.add_argument("-g", type=float)
    ap.add_argument("-ls", type=int)
    ap.add_argument("-ck", type=float)
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--out", type=str, default=None, help="npz trajectory output")
    ap.add_argument("--export-objs", type=str, default=None, help="dir for per-frame .obj")
    ap.add_argument("--screenshots", type=str,
                    default=os.environ.get("ADMM_OUTPUT_DIR"),
                    help="dir for rasterized %%05d.png frames "
                         "(reference Application.hpp:254-272 equivalent)")
    ap.add_argument("--video", type=str, default=None,
                    help="assemble screenshots into a video/gif "
                         "(make_video.sh equivalent; implies --screenshots)")
    ap.add_argument("--cpu", action="store_true", help="force CPU backend")
    args = ap.parse_args(extra)
    if args.show_help:
        settings.help()
        raise SystemExit(0)
    if args.dt is not None:
        settings.timestep_s = args.dt
    if args.v is not None:
        settings.verbose = args.v
    if args.it is not None:
        settings.admm_iters = args.it
    if args.g is not None:
        settings.gravity = args.g
    if args.ls is not None:
        settings.linsolver = args.ls
    if args.ck is not None:
        settings.constraint_w = args.ck
    if args.cpu:
        # jax is already imported (Settings above), so the environment
        # variable would come too late; the config update still applies
        # before the first backend use.
        import jax

        jax.config.update("jax_platforms", "cpu")
    setup_compile_cache()
    return args


def run(solver, args, sim_cb=None, surfaces=None, floor_y=None):
    """Game loop (Application.hpp:227-245, headless)."""
    traj = []
    t0 = time.perf_counter()
    for frame in range(args.frames):
        if sim_cb is not None:
            sim_cb(frame)
        solver.step()
        traj.append(solver.x.copy())
        if args.export_objs and surfaces:
            os.makedirs(args.export_objs, exist_ok=True)
            _export_frame(solver, surfaces, args.export_objs, frame)
    wall = time.perf_counter() - t0
    n = len(traj)
    print(f"\n{n} frames in {wall:.2f}s ({n / wall:.2f} fps, "
          f"{n * solver.m_settings.admm_iters / wall:.1f} ADMM iters/s)")
    if args.out:
        np.savez(args.out, x=np.stack(traj), dt=solver.m_settings.timestep_s)
        print(f"trajectory -> {args.out}")
    shots = args.screenshots or (
        os.path.join(os.path.dirname(args.video) or ".", "frames")
        if args.video else None)
    if shots and surfaces:
        from admm_elastic_tpu.utils.render import render_trajectory

        paths = render_trajectory(np.stack(traj), surfaces, shots,
                                  video=args.video, floor_y=floor_y)
        print(f"screenshots -> {shots}" +
              (f", video -> {paths[-1]}" if args.video else ""))
    return np.stack(traj)


def _export_frame(solver, surfaces, outdir, frame):
    x = solver.x
    path = os.path.join(outdir, f"{frame:05d}.obj")
    with open(path, "w") as f:
        off = 0
        for (v_offset, n_verts, faces) in surfaces:
            for i in range(n_verts):
                p = x[v_offset + i]
                f.write(f"v {p[0]} {p[1]} {p[2]}\n")
            for t in faces:
                f.write(f"f {t[0]+1+off} {t[1]+1+off} {t[2]+1+off}\n")
            off += n_verts
