"""Entry-point plumbing: compile-cache placement, the GPU requirement, and
chip_smoke.py's phase selection and refusal to run without a GPU."""

import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

from admm_elastic_tpu.utils import device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("env_dir", [None, "/some/cache/dir"])
def test_compile_cache_placement(monkeypatch, restore_cache_dir, env_dir):
    before = jax.config.jax_compilation_cache_dir
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert device.setup_compile_cache() == device.CACHE_DIR
        assert jax.config.jax_compilation_cache_dir == device.CACHE_DIR
        # One fixed path inside the checkout.
        assert device.CACHE_DIR == os.path.join(REPO, ".jax_cache")
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
        assert device.setup_compile_cache() == env_dir
        # JAX reads the variable itself; no other directory is set.
        assert jax.config.jax_compilation_cache_dir == before


def test_require_gpu_refuses_the_cpu():
    with pytest.raises(SystemExit, match="no GPU"):
        device.require_gpu()


@pytest.mark.parametrize("argv,want", [
    ([], ["device", "kernels", "scenes", "crossval"]),
    (["--four-cards"], ["device", "four_cards"]),
])
def test_chip_smoke_phase_selection(argv, want):
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    phases, args = chip_smoke.select_phases(argv)
    assert phases == want
    assert args.seed == 0


def _run_smoke(script, cwd, *argv):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run([sys.executable, script, *argv], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _no_result_line(out):
    lines = [ln for ln in out.splitlines() if ln.strip()]
    if not lines:
        return True
    try:
        return json.loads(lines[-1]).get("ok") is not True
    except (json.JSONDecodeError, AttributeError):
        return True


@pytest.mark.parametrize("argv", [[], ["--four-cards"]])
def test_chip_smoke_fails_without_gpu(argv):
    r = _run_smoke(os.path.join(REPO, "chip_smoke.py"), REPO, *argv)
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert _no_result_line(r.stdout)


def test_chip_smoke_fails_outside_a_checkout(tmp_path):
    script = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), script)
    r = _run_smoke(str(script), str(tmp_path))
    assert r.returncode != 0
    assert _no_result_line(r.stdout)
