"""chip_smoke.py off the card: it refuses to run without a GPU, and its
phases — the served path and the four-shard path — pass at a tiny size on
the CPU backend. Also the compile-cache placement it relies on."""
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd, env_extra=None, timeout=120):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **(env_extra or {}))
    env["PYTHONPATH"] = cwd
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def _ok_line(stdout):
    lines = stdout.strip().splitlines()
    if not lines:
        return False
    try:
        return json.loads(lines[-1]).get("ok") is True
    except ValueError:
        return False


def test_smoke_refuses_cpu_backend():
    r = _run(["chip_smoke.py"], ROOT)
    assert r.returncode != 0
    assert not _ok_line(r.stdout)
    assert "no GPU" in r.stderr


def test_smoke_fails_without_the_repo(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py"], str(tmp_path))
    assert r.returncode != 0
    assert not _ok_line(r.stdout)


@pytest.fixture()
def work_dir(tmp_path, monkeypatch):
    import chip_smoke
    monkeypatch.setattr(chip_smoke, "WORK_DIR", str(tmp_path))
    return chip_smoke


def test_smoke_phases_on_cpu(work_dir):
    lines = []
    work_dir.run_served(8000, 4, 120, log=lines.append)
    for phase in "abcdefg":
        assert any(ln.startswith(f"phase {phase}:") for ln in lines), lines
    assert any("identical" in ln for ln in lines)
    # on the CPU the factor weights are exact, none one off
    assert any(re.match(r"phase g: .* 0 of [1-9]\d* weights one off", ln)
               for ln in lines), lines


def test_smoke_four_shard_phases_on_cpu(work_dir):
    lines = []
    work_dir.run_four_cards(8000, 4, log=lines.append)
    assert sum(ln.startswith("phase ") for ln in lines) == 3


def test_smoke_probes_on_cpu(work_dir):
    lines = []
    work_dir.exactness_probes(20000, log=lines.append)
    assert len(lines) == 3


_CACHE_PROBE = (
    "import jax, jax.numpy as jnp;"
    "from manticoresearch_tpu.compile_cache import configure_compile_cache;"
    "d = configure_compile_cache();"
    "jax.jit(lambda x: x * 3 + 1)(jnp.arange(7)).block_until_ready();"
    "print(d); print(jax.config.jax_compilation_cache_dir)")


def _cache_probe(cache_dir):
    """Run _CACHE_PROBE with the cache variables of this test process
    removed, and JAX_COMPILATION_CACHE_DIR=cache_dir unless None."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_COMPILATION_CACHE",
                                "JAX_PERSISTENT_CACHE"))}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    if cache_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = cache_dir
    r = subprocess.run([sys.executable, "-c", _CACHE_PROBE], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    return r.stdout.split()[-2:]


def test_compile_cache_follows_environment(tmp_path):
    used, configured = _cache_probe(str(tmp_path))
    assert used == configured == str(tmp_path)
    assert os.listdir(tmp_path), "nothing was cached in the given directory"


def test_compile_cache_defaults_into_checkout():
    used, configured = _cache_probe(None)
    assert used == configured == os.path.join(ROOT, ".jax_cache")


def test_daemon_module_opens_no_device():
    """The --watchdog parent imports the daemon module and only spawns the
    child: importing it must not initialise a JAX backend (the child alone
    holds the card)."""
    r = _run(["-c", "import manticoresearch_tpu.server.daemon;"
                    "from jax._src import xla_bridge as xb;"
                    "print(sorted(xb._backends))"], ROOT)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "[]"
