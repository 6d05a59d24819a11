"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Sharding/mesh code is validated on virtual CPU devices; tests that need
a GPU carry the ``gpu`` marker and skip here (run them on a GPU machine
with ``python -m pytest tests/ -m gpu``, without JAX_PLATFORMS=cpu).
"""

import os

# Pin the CPU before any backend initializes (jax.config takes effect
# as long as no backend has been used yet).
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_num_cpu_devices", 8)

import pathlib
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

GRAPH_DIR = REPO / "tests" / "graphs"
GOLDEN_DIR = REPO / "tests" / "golden"

FIXTURE_GRAPHS = sorted(p.name for p in GRAPH_DIR.glob("*.gfa"))


@pytest.fixture(params=FIXTURE_GRAPHS)
def graph_path(request) -> pathlib.Path:
    return GRAPH_DIR / request.param


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided at test
    time, never at import: every xdist worker must collect the same
    tests)."""
    from pollen_tpu.device import on_gpu

    if not on_gpu():
        pytest.skip("needs a GPU (JAX default backend is not gpu)")
