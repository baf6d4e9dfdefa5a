"""Device identity and compile-cache placement for the entry points.

Every result a measurement script prints names the device it ran on, and
a measurement script that finds no GPU stops instead of timing the CPU.
"""

from __future__ import annotations

import os
import subprocess

# One fixed compile-cache path inside the checkout (listed in .gitignore):
# the path is part of the cache key, so a cache that moves never hits.
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def setup_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory.

    JAX_COMPILATION_CACHE_DIR, when set, is honoured as JAX reads it and
    no other directory is set; otherwise the cache goes to CACHE_DIR.
    Returns the directory in use.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR


def nvidia_smi() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def require_gpu() -> dict:
    """Fail unless JAX's default device is a GPU; return its identity."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"no GPU found (JAX platform {dev.platform!r}); this script "
            f"measures the GPU and does not fall back to the CPU")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()), "nvidia_smi": nvidia_smi()}
