"""Large-scale smoke: an 8M-step graph through ingest, single-device
and mesh-sharded depth on the virtual CPU mesh.

Gated behind POLLEN_SCALE_TEST=1 (run via `make test-scale`) to keep the
default suite fast.
"""

import os
import time

import numpy as np
import pytest

pytestmark = pytest.mark.skipif(
    os.environ.get("POLLEN_SCALE_TEST") != "1",
    reason="set POLLEN_SCALE_TEST=1 to run the scale smoke",
)


def test_scale_depth_pipeline():
    import jax.numpy as jnp

    import bench as bench_mod
    from pollen_tpu.ops import depth as depth_op
    from pollen_tpu.parallel import (
        make_mesh,
        shard_device_graph,
        sharded_seg_depth_fn,
    )
    from pollen_tpu.parallel.sharded import full_mask

    t0 = time.perf_counter()
    n_steps = 2**23
    g, dg = bench_mod.synth_device_graph(n_steps, 2**19, 256)
    build_time = time.perf_counter() - t0
    assert build_time < 120, f"ingest too slow: {build_time:.1f}s"

    mask = np.ones(dg.num_paths, dtype=bool)
    t0 = time.perf_counter()
    d1, u1 = depth_op.seg_depth_with_uniq_masked(dg, jnp.asarray(mask))
    d1, u1 = np.asarray(d1), np.asarray(u1)
    assert int(d1.sum()) == n_steps

    mesh = make_mesh()
    sg = shard_device_graph(dg, mesh)
    dm, um = sharded_seg_depth_fn(mesh)(sg, full_mask(dg.num_paths))
    np.testing.assert_array_equal(np.asarray(dm), d1)
    np.testing.assert_array_equal(np.asarray(um), u1)


def test_chr8_shaped_synthetic():
    """De-risk the first real-corpus run with a chr8-SHAPED synthetic:
    HPRC chr8 pangenome scale statistics — ~10^8 path steps, ~4M
    segments (avg ~16 bp, ~145 Mbp total like chr8), ~96 haplotype
    paths, Zipf-tailed crossing counts — pushed through ingest, the
    tier planner, and masked depth queries. The hazards this probes:
    planner runtime at millions of segments, int32/packing limits
    (path<<16|count slots, tall-pad blowup), and ingest memory.

    Step count overridable via POLLEN_CHR8_STEPS (the full 10^8 takes
    a few minutes on 2 CPU cores)."""
    import jax.numpy as jnp

    import bench as bench_mod
    from pollen_tpu.ops import depth as depth_op

    n_steps = int(os.environ.get("POLLEN_CHR8_STEPS", 10**8))
    n_segs, n_paths = 2**22, 96

    t0 = time.perf_counter()
    g, dg = bench_mod.synth_device_graph(n_steps, n_segs, n_paths)
    build_time = time.perf_counter() - t0
    print(f"\nchr8-shaped ingest+plan: {build_time:.1f}s "
          f"(S={n_steps:.2g} N={n_segs} P={n_paths})")

    # Planner output must be sane at this scale: classes partition the
    # segment set, slot counts are within the int16 packing limit, and
    # every packed count fits 16 bits (bigger ones must route heavy).
    classes = (
        dg.ell_num_light, dg.ell_num_mid, dg.ell_num_mid2,
        dg.ell_num_heavy,
    )
    print(f"chr8-shaped ELL classes l/m/m2/h={classes}, "
          f"ks=({dg.ell_k},{dg.ell_k2},{dg.ell_k3})")
    if dg.cross_ell.size:
        assert sum(classes) <= n_segs
        from pollen_tpu.kernels.ellscan import COUNT_MAX, unpair_ell16

        flat = np.asarray(dg.cross_ell)
        if dg.ell_pack16:
            flat = unpair_ell16(flat)
        assert int((flat & COUNT_MAX).max()) <= COUNT_MAX
        assert int((flat >> 16).max()) < 2**16

    # Masked depth via the production router vs a direct numpy
    # histogram on the raw arrays.
    rng = np.random.default_rng(4)
    mask = rng.integers(0, 2, n_paths).astype(bool)
    t0 = time.perf_counter()
    d, u = depth_op.seg_depth_with_uniq_masked(dg, jnp.asarray(mask))
    d = np.asarray(d)
    q_time = time.perf_counter() - t0
    print(f"chr8-shaped masked depth (step pipeline): {q_time:.1f}s")

    steps_seg = np.asarray(g.steps) >> 1
    bounds = np.asarray(g.path_steps)
    sel = np.zeros(n_steps, bool)
    for p in np.flatnonzero(mask):
        sel[bounds[p, 0] : bounds[p, 1]] = True
    want = np.bincount(steps_seg[sel], minlength=n_segs)
    np.testing.assert_array_equal(d, want)

    # The ELL route (the index the planner built) must agree too, in
    # natural order via the host un-permute entry.
    if dg.cross_ell.size:
        d_e, u_e = depth_op.seg_depth_with_uniq_ell(
            dg, jnp.asarray(mask.astype(np.int32))
        )
        np.testing.assert_array_equal(np.asarray(d_e), want)


def test_validate_corpus_dry_run(tmp_path):
    """The real-corpus validation script end-to-end on a local fixture
    (the networked deployment runs it with a fetch instead)."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    fixture = tmp_path / "fix.gfa"
    sys.path.insert(0, os.path.join(repo, "tests"))
    from graphgen import big_step_graph

    fixture.write_text(big_step_graph(500, 20000, 8, seed=3))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [
            sys.executable,
            "-m",
            "benchsuite.validate_corpus",
            "hprc.chr8",
            "--graph",
            str(fixture),
        ],
        capture_output=True,
        text=True,
        cwd=repo,
        env=env,
        timeout=600,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "round trip: byte-identical OK" in proc.stdout
    assert "depth: exact-diff OK" in proc.stdout
    assert "degree: exact-diff OK" in proc.stdout
    assert "VALIDATION OK" in proc.stdout
    assert "RESULT hprc.chr8:" in proc.stdout
