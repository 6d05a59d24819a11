"""Device depth/degree kernels vs the spec goldens (exact text parity)."""

import numpy as np
import pytest

from conftest import GOLDEN_DIR
from pollen_tpu.device import build_device_graph
from pollen_tpu.flatgfa import parse_gfa_file
from pollen_tpu.ops import degree as degree_op
from pollen_tpu.ops import depth as depth_op
from pollen_tpu.spec.model import Graph


@pytest.fixture()
def arena(graph_path):
    g = parse_gfa_file(str(graph_path))
    return g, build_device_graph(g)


def test_seg_depth_matches_golden(graph_path, arena):
    g, dg = arena
    golden = (GOLDEN_DIR / f"{graph_path.stem}.depth").read_text()
    assert depth_op.run_seg_depth(g, dg) == golden


def test_seg_depth_subset_matches_golden(graph_path, arena):
    g, dg = arena
    golden = (GOLDEN_DIR / f"{graph_path.stem}.depth_subset").read_text()
    subset = [
        ln
        for ln in (GOLDEN_DIR / f"{graph_path.stem}.depthpaths")
        .read_text()
        .splitlines()
        if ln
    ]
    assert depth_op.run_seg_depth(g, dg, subset) == golden


def test_seg_depth_heavy_split_end_to_end():
    """run_seg_depth with a heavy-split ELL graph: each impl — and the
    auto-picked one — renders the identical subset TSV in NATURAL
    segment order (the permuted device layout must never leak)."""
    import jax.numpy as jnp

    from pollen_tpu.flatgfa import parse_gfa

    lines = ["S\t1\tAA"] + [f"S\t{i}\tC" for i in range(2, 40)]
    lines += ["P\tp0\t" + ",".join(["1+"] * 20) + ",2+\t*"]
    lines += [f"P\tp{j}\t1+,{2 + (j % 38)}+\t*" for j in range(1, 40)]
    g = parse_gfa(("\n".join(lines) + "\n").encode())
    dg = build_device_graph(g, cross_matrix="always")
    assert dg.ell_heavy.size  # the split layout is in play
    subset = ["p0", "p3", "p17"]
    auto = depth_op.run_seg_depth(g, dg, subset)
    mask = jnp.asarray(depth_op.path_mask_for(g, subset))
    for fn in (
        depth_op.seg_depth_with_uniq_ell,
        depth_op.seg_depth_with_uniq_cross,
        depth_op.seg_depth_with_uniq_masked,
    ):
        d, u = fn(dg, mask)
        table = depth_op.seg_depth_table(
            g, np.asarray(d), np.asarray(u)
        )
        assert table == auto, fn.__name__


def test_degree_matches_golden(graph_path, arena):
    g, dg = arena
    golden = (GOLDEN_DIR / f"{graph_path.stem}.degree").read_text()
    assert degree_op.run_degree(g, dg) == golden


def test_empty_subset(graph_path, arena):
    g, dg = arena
    table = depth_op.run_seg_depth(g, dg, [])
    for line in table.splitlines()[1:]:
        _, d, u = line.split("\t")
        assert d == "0" and u == "0"


def test_path_depth_weighted_mean(arena):
    """path_depth agrees with a straightforward spec-level recomputation."""
    g, dg = arena
    spec = Graph.parse_lines(iter(_arena_text(g).splitlines()))
    lengths, sums = depth_op.path_depth(dg)
    lengths, sums = np.asarray(lengths), np.asarray(sums)

    # Spec-level: seg depth by brute force, then length-weighted mean.
    seg_depth = {name: 0 for name in spec.segments}
    for path in spec.paths.values():
        for step in path.steps:
            seg_depth[step.name] += 1
    for i, (pname, path) in enumerate(spec.paths.items()):
        want_len = sum(len(spec.segments[s.name].seq) for s in path.steps)
        want_sum = sum(
            seg_depth[s.name] * len(spec.segments[s.name].seq)
            for s in path.steps
        )
        assert lengths[i] == want_len
        assert sums[i] == want_sum


def _arena_text(g):
    from pollen_tpu.emit import emit_gfa

    return emit_gfa(g, order="preserved")


def test_format_float():
    f = depth_op.format_float
    assert f(2.0, 2) == "2"
    assert f(2.5, 2) == "2.5"
    assert f(2.504, 2) == "2.5"
    assert f(2.505, 2) == "2.51" or f(2.505, 2) == "2.5"  # banker's edge
    assert f(0.0, 2) == "0"


def test_runs_variant_matches_masked(graph_path, arena):
    """The O(R) run-level masked depth equals the O(S) pipelines."""
    import jax.numpy as jnp

    g, dg = arena
    rng = np.random.default_rng(5)
    for _ in range(3):
        mask = rng.integers(0, 2, dg.num_paths).astype(bool)
        d_r, u_r = depth_op.seg_depth_with_uniq_runs(dg, jnp.asarray(mask))
        d_s, u_s = depth_op.seg_depth_with_uniq_masked(dg, jnp.asarray(mask))
        np.testing.assert_array_equal(np.asarray(d_r), np.asarray(d_s))
        np.testing.assert_array_equal(np.asarray(u_r), np.asarray(u_s))


def test_batched_queries(graph_path, arena):
    import jax.numpy as jnp

    g, dg = arena
    rng = np.random.default_rng(9)
    masks = rng.integers(0, 2, (5, dg.num_paths)).astype(bool)
    d_b, u_b = depth_op.seg_depth_with_uniq_batch(dg, jnp.asarray(masks))
    for q in range(5):
        d, u = depth_op.seg_depth_with_uniq_masked(
            dg, jnp.asarray(masks[q])
        )
        np.testing.assert_array_equal(np.asarray(d_b)[q], np.asarray(d))
        np.testing.assert_array_equal(np.asarray(u_b)[q], np.asarray(u))


def test_cost_model_routing():
    """Masked queries route to the first resident index of ELL, the
    crossing matrix, the run-level index and the step list."""
    import bench as bench_mod

    # Zipf shapes build both resident indexes; the ELL index serves.
    _, dg_small = bench_mod.synth_device_graph(2**18, 2**14, 64)
    assert dg_small.cross_matrix.size and dg_small.cross_ell.size
    assert depth_op._best_masked_impl(dg_small) == "ell"
    _, dg = bench_mod.synth_device_graph(2**22, 2**18, 128)
    assert dg.cross_ell.size
    assert depth_op._best_masked_impl(dg) == "ell"

    # With both resident indexes suppressed, the run-level index
    # serves; projections without it fall to the step list.
    import os

    os.environ["POLLEN_CROSS_BUDGET_MB"] = "0"
    try:
        _, dg2 = bench_mod.synth_device_graph(2**18, 2**14, 64, "host")
    finally:
        del os.environ["POLLEN_CROSS_BUDGET_MB"]
    assert dg2.cross_matrix.size == 0 and dg2.cross_ell.size == 0
    assert depth_op._best_masked_impl(dg2) == "runs"
    assert depth_op._best_masked_impl(
        bench_mod.project_host(dg2, "xla")
    ) == "xla"
    assert depth_op._best_masked_impl(
        bench_mod.project_host(dg_small, "cross")
    ) == "cross"


def test_ell_batch_matches_per_query():
    """Batched tiered-ELL queries (natural order) equal Q single
    queries on a Zipf graph with heavy + empty classes present."""
    import jax.numpy as jnp

    import bench

    _, dg = bench.synth_device_graph(2**14, 2**10, 48)
    assert dg.cross_ell.size and dg.ell_heavy.size
    rng = np.random.default_rng(31)
    masks = rng.integers(0, 2, (6, dg.num_paths)).astype(bool)
    d_b, u_b = depth_op.seg_depth_with_uniq_ell_batch(
        dg, jnp.asarray(masks)
    )
    assert d_b.shape == (6, dg.num_segments)
    for q in range(6):
        d, u = depth_op.seg_depth_with_uniq_masked(
            dg, jnp.asarray(masks[q])
        )
        np.testing.assert_array_equal(np.asarray(d_b)[q], np.asarray(d))
        np.testing.assert_array_equal(np.asarray(u_b)[q], np.asarray(u))


def test_batch_router_prefers_ell():
    """seg_depth_with_uniq_batch routes through the batched ELL path
    when the router picks the ELL index (regression: batches used to
    regress to the crossing matrix / runs vmap)."""
    import jax.numpy as jnp

    import bench

    _, dg = bench.synth_device_graph(2**18, 2**16, 128)
    assert depth_op._best_masked_impl(dg) == "ell"
    rng = np.random.default_rng(33)
    masks = rng.integers(0, 2, (4, dg.num_paths)).astype(bool)
    d_b, u_b = depth_op.seg_depth_with_uniq_batch(dg, jnp.asarray(masks))
    d_e, u_e = depth_op.seg_depth_with_uniq_ell_batch(
        dg, jnp.asarray(masks)
    )
    np.testing.assert_array_equal(np.asarray(d_b), np.asarray(d_e))
    np.testing.assert_array_equal(np.asarray(u_b), np.asarray(u_e))


def _three_tier_graph(n1=40000, n2=40000, n3=20000, nh=200, p=64):
    """A synthetic arena whose run distribution makes the planner pick
    THREE tiers (r runs/segment = 1, 4, 16 for the tier blocks) plus a
    small heavy class (40 runs > the largest K). The tests zero
    C_TIER_FIXED so the fixture stays small; the marginal tall-pad
    economics then favor the full split."""
    from pollen_tpu.flatgfa import GraphArrays

    n = n1 + n2 + n3 + nh
    seg_ids = []
    path_ids = []
    blocks = (
        (0, n1, 1),
        (n1, n2, 4),
        (n1 + n2, n3, 16),
        (n1 + n2 + n3, nh, 40),
    )
    for base, count, r in blocks:
        s = np.arange(base, base + count, dtype=np.int64)
        for i in range(r):
            seg_ids.append(s)
            path_ids.append((s + i) % p)
    seg = np.concatenate(seg_ids)
    pth = np.concatenate(path_ids)
    order = np.argsort(pth, kind="stable")
    seg, pth = seg[order], pth[order]
    steps = (seg.astype(np.uint32) << np.uint32(1))
    counts = np.bincount(pth, minlength=p)
    bounds = np.concatenate(([0], np.cumsum(counts))).astype(np.uint32)
    path_steps = np.stack([bounds[:-1], bounds[1:]], axis=1)
    seg_lens = np.ones(n, np.uint32)
    sb = np.concatenate(([0], np.cumsum(seg_lens))).astype(np.uint32)
    return GraphArrays(
        header=np.zeros(0, np.uint8),
        seg_name=np.arange(1, n + 1, dtype=np.int64),
        seg_seq=np.stack([sb[:-1], sb[1:]], axis=1),
        seg_optional=np.zeros((n, 2), np.uint32),
        path_name=np.zeros((p, 2), np.uint32),
        path_steps=path_steps,
        path_overlaps=np.zeros((p, 2), np.uint32),
        link_from=np.zeros(0, np.uint32),
        link_to=np.zeros(0, np.uint32),
        link_overlap=np.zeros((0, 2), np.uint32),
        steps=steps,
        seq_data=np.zeros(int(sb[-1]), np.uint8),
        overlaps=np.zeros((0, 2), np.uint32),
        alignment=np.zeros(0, np.uint32),
        name_data=np.zeros(0, np.uint8),
        optional_data=np.zeros(0, np.uint8),
        line_order=np.zeros(0, np.uint8),
    )


def test_three_tier_split_exact(monkeypatch):
    """When the planner picks a third tier, the single-query, batch,
    and natural-order compositions all stay exact."""
    import jax.numpy as jnp

    from pollen_tpu.device import build_device_graph
    from pollen_tpu.kernels import ellscan

    monkeypatch.setattr(ellscan, "C_TIER_FIXED", 0.0)
    monkeypatch.setattr(ellscan, "C_COL_B", 0.0)
    g = _three_tier_graph()
    dg = build_device_graph(g)
    assert dg.ell_k3 > 0 and dg.ell_num_mid2 > 0, (
        dg.ell_k, dg.ell_k2, dg.ell_k3, dg.ell_num_mid, dg.ell_num_mid2
    )
    rng = np.random.default_rng(41)
    mask = jnp.asarray(rng.integers(0, 2, dg.num_paths).astype(bool))
    d_ref, u_ref = depth_op.seg_depth_with_uniq_masked(dg, mask)
    d_e, u_e = depth_op.seg_depth_with_uniq_ell(dg, mask)
    np.testing.assert_array_equal(np.asarray(d_e), np.asarray(d_ref))
    np.testing.assert_array_equal(np.asarray(u_e), np.asarray(u_ref))

    masks = jnp.asarray(rng.integers(0, 2, (3, dg.num_paths)).astype(bool))
    d_b, u_b = depth_op.seg_depth_with_uniq_ell_batch(dg, masks)
    for q in range(3):
        d1, u1 = depth_op.seg_depth_with_uniq_masked(dg, masks[q])
        np.testing.assert_array_equal(d_b[q], np.asarray(d1))
        np.testing.assert_array_equal(u_b[q], np.asarray(u1))


def test_three_tier_sharded_exact(monkeypatch):
    """Sharded tiered ELL with a live third tier equals the
    single-device reference."""
    import jax
    import jax.numpy as jnp

    from pollen_tpu.device import build_device_graph
    from pollen_tpu.kernels import ellscan
    from pollen_tpu.parallel import make_mesh
    from pollen_tpu.parallel.sharded import (
        compose_ell_parts_natural,
        shard_ell_inputs,
        sharded_ell_depth_fn,
    )

    monkeypatch.setattr(ellscan, "C_TIER_FIXED", 0.0)
    monkeypatch.setattr(ellscan, "C_COL_B", 0.0)
    g = _three_tier_graph()
    dg = build_device_graph(g)
    mesh = make_mesh(jax.devices()[:8])
    se = shard_ell_inputs(dg, mesh)
    assert se is not None and se.ell3 is not None
    rng = np.random.default_rng(43)
    bools = rng.integers(0, 2, dg.num_paths).astype(bool)
    m = jnp.asarray(bools.astype(np.int32))
    args = [se.ell]
    has_mid = se.ell2 is not None
    if has_mid:
        args.append(se.ell2)
    args.append(se.ell3)
    has_heavy = se.heavy is not None
    if has_heavy:
        args += [se.heavy, se.heavy_res, se.heavy_res_col]
    args.append(m)
    parts = sharded_ell_depth_fn(
        mesh, has_heavy=has_heavy, has_mid=has_mid, has_mid2=True
    )(*args)
    d_e, u_e = compose_ell_parts_natural(
        dg, parts, has_mid=has_mid, has_heavy=has_heavy, has_mid2=True
    )
    d_ref, u_ref = depth_op.seg_depth_with_uniq_masked(
        dg, jnp.asarray(bools)
    )
    np.testing.assert_array_equal(d_e, np.asarray(d_ref))
    np.testing.assert_array_equal(u_e, np.asarray(u_ref))


def test_cost_model_high_path_corner():
    """P >= 2^16 paths: the int16 slot packing bars the ELL index, so
    the next resident index serves — and answers exactly."""
    import jax.numpy as jnp

    import bench as bench_mod

    _, dg = bench_mod.synth_device_graph(2**16, 2**10, 70000)
    assert dg.cross_ell.size == 0  # int16 packing bar
    assert depth_op._best_masked_impl(dg) in ("cross", "runs")
    rng = np.random.default_rng(3)
    mask = jnp.asarray(rng.integers(0, 2, dg.num_paths).astype(bool))
    impl = depth_op._MASKED_IMPLS[depth_op._best_masked_impl(dg)]
    d, u = impl(dg, mask)
    d_x, u_x = depth_op.seg_depth_with_uniq_masked(dg, mask)
    np.testing.assert_array_equal(np.asarray(d), np.asarray(d_x))
    np.testing.assert_array_equal(np.asarray(u), np.asarray(u_x))


def test_batch_objective_plan_exact():
    """ell_objective='batch' (amortized per-phase fixed cost) produces
    a finer tier split that stays exact through every query form."""
    import jax.numpy as jnp

    import bench
    from pollen_tpu.device import build_device_graph
    from pollen_tpu.flatgfa import parse_gfa

    g, _ = bench.synth_device_graph(2**14, 2**10, 48, device="host")
    # Rebuild the arena-level graph through the public builder.
    dg_b = build_device_graph(g, ell_objective="batch")
    dg_s = build_device_graph(g, ell_objective="single")
    assert dg_b.cross_ell.size
    rng = np.random.default_rng(71)
    mask = jnp.asarray(rng.integers(0, 2, dg_b.num_paths).astype(bool))
    d_ref, u_ref = depth_op.seg_depth_with_uniq_masked(dg_s, mask)
    d_b, u_b = depth_op.seg_depth_with_uniq_ell(dg_b, mask)
    np.testing.assert_array_equal(np.asarray(d_b), np.asarray(d_ref))
    np.testing.assert_array_equal(np.asarray(u_b), np.asarray(u_ref))
    masks = jnp.asarray(
        rng.integers(0, 2, (3, dg_b.num_paths)).astype(bool)
    )
    d_q, u_q = depth_op.seg_depth_with_uniq_ell_batch(dg_b, masks)
    for q in range(3):
        d1, u1 = depth_op.seg_depth_with_uniq_masked(dg_s, masks[q])
        np.testing.assert_array_equal(d_q[q], np.asarray(d1))
        np.testing.assert_array_equal(u_q[q], np.asarray(u1))


def test_ell_batch_chunking():
    """Batches past ELL_BATCH_CHUNK split into chunk-sized device calls
    with identical results."""
    import jax.numpy as jnp

    import bench
    from pollen_tpu.ops import depth as d

    _, dg = bench.synth_device_graph(2**13, 2**9, 32)
    rng = np.random.default_rng(77)
    q = d.ELL_BATCH_CHUNK + 5
    masks = jnp.asarray(rng.integers(0, 2, (q, dg.num_paths)).astype(bool))
    db, ub = d.seg_depth_with_uniq_ell_batch(dg, masks)
    assert db.shape == (q, dg.num_segments)
    for i in (0, d.ELL_BATCH_CHUNK - 1, d.ELL_BATCH_CHUNK, q - 1):
        d1, u1 = d.seg_depth_with_uniq_masked(dg, masks[i])
        np.testing.assert_array_equal(db[i], np.asarray(d1))
        np.testing.assert_array_equal(ub[i], np.asarray(u1))


def test_pack16_ab_equivalence(monkeypatch):
    """The same graph ingested with pack16 on and off answers every
    masked/batched/all-paths depth query identically (the layouts may
    route segments differently — counts > 255 go heavy under pack16 —
    but the answers must not move)."""
    import jax.numpy as jnp

    import bench as bench_mod

    g, dg16 = bench_mod.synth_device_graph(2**14, 2**10, 48, device="host")
    assert dg16.ell_pack16 == 1
    monkeypatch.setenv("POLLEN_ELL_PACK16", "0")
    from pollen_tpu.device import build_device_graph

    dg32 = build_device_graph(g, minimal=True, device="host")
    assert dg32.ell_pack16 == 0

    rng = np.random.default_rng(41)
    for trial in range(3):
        mask = rng.integers(0, 2, dg16.num_paths).astype(np.int32)
        d_ref, u_ref = depth_op.seg_depth_with_uniq_masked(
            dg32, jnp.asarray(mask.astype(bool))
        )
        for dg in (dg16, dg32):
            d, u = depth_op.seg_depth_with_uniq_ell(dg, jnp.asarray(mask))
            np.testing.assert_array_equal(np.asarray(d), np.asarray(d_ref))
            np.testing.assert_array_equal(np.asarray(u), np.asarray(u_ref))
    masks = rng.integers(0, 2, (5, dg16.num_paths)).astype(np.int32)
    d16, u16 = depth_op.seg_depth_with_uniq_ell_batch(
        dg16, jnp.asarray(masks)
    )
    d32, u32 = depth_op.seg_depth_with_uniq_ell_batch(
        dg32, jnp.asarray(masks)
    )
    np.testing.assert_array_equal(d16, d32)
    np.testing.assert_array_equal(u16, u32)
