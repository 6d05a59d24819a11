"""bench.py's per-impl DeviceGraph projection: shipping only the
chosen index's tensors must not change any impl's answer (the round-3
driver bench died uploading indexes it never measured)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bench import (
    _IMPL_FIELDS,
    project_for_impl,
    synth_device_graph,
)


def _masks(n_paths, seed=7):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.integers(0, 2, n_paths).astype(np.int32))


@pytest.fixture(scope="module")
def graphs():
    # Big enough that the tiered ELL split has all classes and the
    # crossing matrix is built.
    _, dg_host = synth_device_graph(2**14, 2**10, 48, device="host")
    _, dg_full = synth_device_graph(2**14, 2**10, 48)
    return dg_host, dg_full


def test_host_ingest_matches_device(graphs):
    dg_host, dg_full = graphs
    for name in ("step_path_sorted", "seg_bounds", "cross_ell",
                 "cross_matrix", "ell_heavy", "run_start"):
        h = getattr(dg_host, name)
        assert isinstance(h, np.ndarray), name
        np.testing.assert_array_equal(h, np.asarray(getattr(dg_full, name)))
    assert dg_host.ell_k == dg_full.ell_k
    assert dg_host.num_paths == dg_full.num_paths


@pytest.mark.parametrize("impl", sorted(_IMPL_FIELDS))
def test_projection_preserves_answers(graphs, impl):
    from pollen_tpu.ops.depth import (
        _MASKED_IMPLS,
        seg_depth_with_uniq_ell_permuted,
        seg_depth_with_uniq_masked,
    )

    dg_host, dg_full = graphs
    mask = _masks(dg_full.num_paths)
    dg_proj = project_for_impl(dg_host, impl)

    # Kept fields are device arrays; dropped data fields are zero-size.
    for f in _IMPL_FIELDS[impl]:
        assert isinstance(getattr(dg_proj, f), jax.Array)
    if impl == "ell":
        assert dg_proj.cross_matrix.size == 0
        d, u = seg_depth_with_uniq_ell_permuted(dg_proj, mask)
        d_ref, u_ref = seg_depth_with_uniq_ell_permuted(dg_full, mask)
    else:
        if impl == "cross":
            assert dg_proj.cross_ell.size == 0
        d, u = _MASKED_IMPLS[impl](dg_proj, mask)
        d_ref, u_ref = seg_depth_with_uniq_masked(dg_full, mask)
    np.testing.assert_array_equal(np.asarray(d), np.asarray(d_ref))
    np.testing.assert_array_equal(np.asarray(u), np.asarray(u_ref))


def test_time_calls_blocks_and_counts():
    """time_calls returns the first call's result and time, then one
    positive wall time per warm call, each ended by block_until_ready."""
    import bench

    calls = []

    def fn(x):
        calls.append(1)
        return x + 1

    out, first, times = bench.time_calls(fn, (jnp.ones(4),), reps=5)
    assert len(times) == 5 and len(calls) == 6
    assert first > 0 and all(t > 0 for t in times)
    np.testing.assert_array_equal(np.asarray(out), 2 * np.ones(4))


def test_synth_graph_names_and_links():
    """The synthetic arena names its paths p0..p{P-1}, and links=True
    adds one link per distinct consecutive step pair within a path."""
    import bench

    g = bench.synth_graph(2**10, 2**6, 4, links=True)
    assert g.path_names() == [b"p0", b"p1", b"p2", b"p3"]
    steps = np.asarray(g.steps)
    want = set()
    for lo, hi in np.asarray(g.path_steps):
        want |= set(zip(steps[lo : hi - 1].tolist(), steps[lo + 1 : hi].tolist()))
    got = set(zip(np.asarray(g.link_from).tolist(), np.asarray(g.link_to).tolist()))
    assert got == want and len(got) == g.link_from.size
