"""Process-level settings of pollen_tpu.device: the persistent compile
cache directory and the backend predicate."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE = (
    "import jax, pollen_tpu.device as d; "
    "print(jax.config.jax_compilation_cache_dir); print(d.DEFAULT_CACHE_DIR)"
)


def _probe(env_update, drop=()):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **env_update)
    for k in drop:
        env.pop(k, None)
    out = subprocess.run(
        [sys.executable, "-c", PROBE], env=env, cwd=REPO,
        capture_output=True, text=True, timeout=120, check=True,
    ).stdout.split("\n")
    return out[0], out[1]


def test_compile_cache_follows_env(tmp_path):
    """JAX_COMPILATION_CACHE_DIR, when set, is the cache directory; the
    package sets no other."""
    cache, _ = _probe({"JAX_COMPILATION_CACHE_DIR": str(tmp_path)})
    assert cache == str(tmp_path)


def test_compile_cache_defaults_to_checkout():
    """Without the variable the cache is <checkout>/.jax_cache."""
    cache, default = _probe({}, drop=("JAX_COMPILATION_CACHE_DIR",))
    assert cache == default == os.path.join(REPO, ".jax_cache")


def test_on_gpu_false_on_cpu():
    from pollen_tpu.device import on_gpu

    assert on_gpu() is False
