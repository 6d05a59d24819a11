"""Sharded (mesh) depth vs the single-device kernels, on a virtual
8-device CPU mesh."""

import jax
import numpy as np
import pytest

from pollen_tpu.device import build_device_graph
from pollen_tpu.flatgfa import parse_gfa_file
from pollen_tpu.ops import depth as depth_op
from pollen_tpu.parallel import (
    make_mesh,
    shard_device_graph,
    sharded_seg_depth_fn,
)
from pollen_tpu.parallel.sharded import full_mask

import jax.numpy as jnp


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, "tests expect 8 virtual CPU devices"
    return make_mesh()


def test_mesh_shape(mesh):
    assert mesh.shape == {"host": 1, "chip": 8}


def test_sharded_depth_matches_single(graph_path, mesh):
    g = parse_gfa_file(str(graph_path))
    dg = build_device_graph(g)
    sg = shard_device_graph(dg, mesh)
    query = sharded_seg_depth_fn(mesh)

    depth_m, uniq_m = query(sg, full_mask(dg.num_paths))
    depth_1, uniq_1 = depth_op.seg_depth_with_uniq(dg)
    np.testing.assert_array_equal(np.asarray(depth_m), np.asarray(depth_1))
    np.testing.assert_array_equal(np.asarray(uniq_m), np.asarray(uniq_1))


def test_sharded_depth_masked_matches_single(graph_path, mesh):
    g = parse_gfa_file(str(graph_path))
    dg = build_device_graph(g)
    sg = shard_device_graph(dg, mesh)
    query = sharded_seg_depth_fn(mesh)

    # Drop every other path.
    mask = np.zeros(dg.num_paths + 1, dtype=np.int32)
    mask[0 : dg.num_paths : 2] = 1
    depth_m, uniq_m = query(sg, jnp.asarray(mask))
    depth_1, uniq_1 = depth_op.seg_depth_with_uniq_masked(
        dg, jnp.asarray(mask[:-1].astype(bool))
    )
    np.testing.assert_array_equal(np.asarray(depth_m), np.asarray(depth_1))
    np.testing.assert_array_equal(np.asarray(uniq_m), np.asarray(uniq_1))


def test_sharded_uniq_straddling_groups(mesh):
    """A graph built so one (segment, path) group spans several chunks:
    one segment crossed 64 times by one path. Uniq must still be 1."""
    steps = ",".join(["1+"] * 64)
    text = f"H\tVN:Z:1.0\nS\t1\tACGT\nS\t2\tT\nP\tbig\t{steps}\t*\nP\tb2\t2+,1+\t*\n"
    from pollen_tpu.flatgfa import parse_gfa

    g = parse_gfa(text.encode())
    dg = build_device_graph(g)
    sg = shard_device_graph(dg, mesh)
    query = sharded_seg_depth_fn(mesh)
    depth_m, uniq_m = query(sg, full_mask(dg.num_paths))
    assert np.asarray(depth_m).tolist() == [65, 1]
    assert np.asarray(uniq_m).tolist() == [2, 1]


def test_sharded_degree_matches_single(graph_path, mesh):
    from pollen_tpu.ops.degree import seg_degree
    from pollen_tpu.parallel.sharded import (
        shard_degree_inputs,
        sharded_degree_fn,
    )

    g = parse_gfa_file(str(graph_path))
    dg = build_device_graph(g)
    weights, chunk_starts, bounds = shard_degree_inputs(dg, mesh)
    deg_m = sharded_degree_fn(mesh)(weights, chunk_starts, bounds)
    np.testing.assert_array_equal(
        np.asarray(deg_m), np.asarray(seg_degree(dg))
    )


def test_sharded_depth_scatter_output(graph_path, mesh):
    """Output-sharded depth (psum_scatter over chips) gathers to the
    same answer as the replicated-output query."""
    from pollen_tpu.parallel.sharded import sharded_seg_depth_scatter_fn

    g = parse_gfa_file(str(graph_path))
    dg = build_device_graph(g)
    sg = shard_device_graph(dg, mesh)
    d_r, u_r = sharded_seg_depth_fn(mesh)(sg, full_mask(dg.num_paths))
    d_s, u_s = sharded_seg_depth_scatter_fn(mesh)(sg, full_mask(dg.num_paths))
    n = dg.num_segments
    np.testing.assert_array_equal(np.asarray(d_s).reshape(-1)[:n], np.asarray(d_r))
    np.testing.assert_array_equal(np.asarray(u_s).reshape(-1)[:n], np.asarray(u_r))


def test_sharded_cross_depth_matches_single(graph_path, mesh):
    """Tensor-parallel crossing matrix (zero-collective) vs the
    single-device masked pipeline, including the overflow fixup."""
    from pollen_tpu.parallel.sharded import (
        shard_cross_inputs,
        sharded_cross_depth_fn,
    )

    g = parse_gfa_file(str(graph_path))
    dg = build_device_graph(g, cross_matrix="always")
    sc = shard_cross_inputs(dg, mesh)
    assert sc is not None
    query = sharded_cross_depth_fn(mesh, nibble=sc.nibble)

    rng = np.random.default_rng(23)
    n = dg.num_segments
    for _ in range(2):
        bools = rng.integers(0, 2, dg.num_paths).astype(bool)
        m = (
            jnp.zeros(sc.num_paths_padded, jnp.int32)
            .at[: dg.num_paths]
            .set(jnp.asarray(bools.astype(np.int32)))
        )
        d_c, u_c = query(sc.cross, sc.res, sc.res_seg, m)
        d_1, u_1 = depth_op.seg_depth_with_uniq_masked(dg, jnp.asarray(bools))
        np.testing.assert_array_equal(np.asarray(d_c)[:n], np.asarray(d_1))
        np.testing.assert_array_equal(np.asarray(u_c)[:n], np.asarray(u_1))


def _sharded_ell_natural(dg, se, mesh, bools):
    """Run the sharded tiered split-ELL query and reassemble natural
    order via the shared composition helper."""
    from pollen_tpu.parallel.sharded import (
        compose_ell_parts_natural,
        sharded_ell_depth_fn,
    )

    m = jnp.asarray(bools.astype(np.int32))
    has_mid = se.ell2 is not None
    has_mid2 = se.ell3 is not None
    has_heavy = se.heavy is not None
    args = [se.ell]
    if has_mid:
        args.append(se.ell2)
    if has_mid2:
        args.append(se.ell3)
    if has_heavy:
        args += [se.heavy, se.heavy_res, se.heavy_res_col]
    args.append(m)
    parts = sharded_ell_depth_fn(
        mesh, has_heavy=has_heavy, has_mid=has_mid, has_mid2=has_mid2
    )(*args)
    return compose_ell_parts_natural(
        dg, parts, has_mid=has_mid, has_heavy=has_heavy,
        has_mid2=has_mid2,
    )


def test_sharded_ell_depth_matches_single(graph_path, mesh):
    """Tensor-parallel split ELL run index (zero-collective) vs the
    single-device masked pipeline."""
    from pollen_tpu.parallel.sharded import shard_ell_inputs

    g = parse_gfa_file(str(graph_path))
    dg = build_device_graph(g, cross_matrix="always")
    se = shard_ell_inputs(dg, mesh)
    assert se is not None

    rng = np.random.default_rng(29)
    for _ in range(2):
        bools = rng.integers(0, 2, dg.num_paths).astype(bool)
        d_e, u_e = _sharded_ell_natural(dg, se, mesh, bools)
        d_1, u_1 = depth_op.seg_depth_with_uniq_masked(dg, jnp.asarray(bools))
        np.testing.assert_array_equal(d_e, np.asarray(d_1))
        np.testing.assert_array_equal(u_e, np.asarray(u_1))


def test_sharded_ell_heavy_sidecar(mesh):
    """Heavy segments' nibble columns (and clip residual) land on the
    right device shard and reconstruct exactly."""
    from pollen_tpu.flatgfa import parse_gfa
    from pollen_tpu.parallel.sharded import shard_ell_inputs

    # Segment 1 gets 40 single-crossing runs (heavy for small K) plus
    # a count-21 run (clip residual).
    lines = ["S\t1\tAA"] + [f"S\t{i}\tC" for i in range(2, 40)]
    lines += ["P\tp0\t" + ",".join(["1+"] * 20) + ",2+\t*"]
    lines += [f"P\tp{j}\t1+,{2 + (j % 38)}+\t*" for j in range(1, 40)]
    text = ("\n".join(lines) + "\n").encode()
    dg = build_device_graph(parse_gfa(text), cross_matrix="always")
    se = shard_ell_inputs(dg, mesh)
    assert se is not None and se.heavy is not None
    assert dg.ell_heavy_res_col.size
    bools = np.ones(dg.num_paths, bool)
    d_e, u_e = _sharded_ell_natural(dg, se, mesh, bools)
    d_1, u_1 = depth_op.seg_depth_with_uniq_masked(
        dg, jnp.ones(dg.num_paths, bool)
    )
    np.testing.assert_array_equal(d_e, np.asarray(d_1))
    np.testing.assert_array_equal(u_e, np.asarray(u_1))


def test_sharded_cross_overflow(mesh):
    """Clipped residuals land on the right device shard."""
    from pollen_tpu.flatgfa import parse_gfa
    from pollen_tpu.parallel.sharded import (
        shard_cross_inputs,
        sharded_cross_depth_fn,
    )

    steps = ",".join(["1+"] * 300 + ["2+"] * 2)
    text = f"S\t1\tA\nS\t2\tC\nP\tp\t{steps}\t*\n".encode()
    dg = build_device_graph(parse_gfa(text), cross_matrix="always")
    assert dg.cross_res_seg.size
    sc = shard_cross_inputs(dg, mesh)
    m = jnp.zeros(sc.num_paths_padded, jnp.int32).at[:1].set(1)
    d_c, u_c = sharded_cross_depth_fn(mesh, nibble=sc.nibble)(
        sc.cross, sc.res, sc.res_seg, m
    )
    assert np.asarray(d_c)[:2].tolist() == [300, 2]
    assert np.asarray(u_c)[:2].tolist() == [1, 1]


def test_sharded_scan_straddling_zipf(mesh):
    """The step-sharded XLA scan (all-gather lookback carry + psum)
    matches the single-device reference on a Zipf graph whose
    (segment, path) groups straddle chunk boundaries."""
    import bench

    rng = np.random.default_rng(11)
    n_steps, n_segs, n_paths = 4 * 16384, 200, 24
    _, dg = bench.synth_device_graph(n_steps, n_segs, n_paths)
    sg = shard_device_graph(dg, mesh)
    rs = np.asarray(sg.run_start)
    starts = [sg.chunk * d for d in range(1, mesh.size)]
    assert any(rs[s] < s for s in starts), "no straddling group"

    mask = np.zeros(n_paths + 1, np.int32)
    mask[:n_paths] = rng.integers(0, 2, n_paths)
    d_x, u_x = sharded_seg_depth_fn(mesh)(sg, jnp.asarray(mask))
    d_1, u_1 = depth_op.seg_depth_with_uniq_masked(
        dg, jnp.asarray(mask[:-1].astype(bool))
    )
    np.testing.assert_array_equal(np.asarray(d_x), np.asarray(d_1))
    np.testing.assert_array_equal(np.asarray(u_x), np.asarray(u_1))


def test_sharded_scatter_straddling_zipf(mesh):
    """The reduce-scatter output form on the same straddling graph
    gathers to the single-device answer."""
    import bench
    from pollen_tpu.parallel.sharded import sharded_seg_depth_scatter_fn

    _, dg = bench.synth_device_graph(4 * 16384, 200, 24)
    sg = shard_device_graph(dg, mesh)
    mask = np.ones(25, np.int32)
    mask[-1] = 0
    mask[::3] = 0
    d_s, u_s = sharded_seg_depth_scatter_fn(mesh)(sg, jnp.asarray(mask))
    d_1, u_1 = depth_op.seg_depth_with_uniq_masked(
        dg, jnp.asarray(mask[:-1].astype(bool))
    )
    n = dg.num_segments
    np.testing.assert_array_equal(np.asarray(d_s).reshape(-1)[:n], np.asarray(d_1))
    np.testing.assert_array_equal(np.asarray(u_s).reshape(-1)[:n], np.asarray(u_1))


@pytest.mark.parametrize("n_dev", [1, 4, 8])
def test_make_mesh_default_shape(n_dev):
    """The default mesh has one host row per process and every given
    device on the chip axis, in order."""
    m = make_mesh(jax.devices()[:n_dev])
    assert dict(m.shape) == {"host": jax.process_count(), "chip": n_dev}
    assert list(m.devices.reshape(-1)) == jax.devices()[:n_dev]


def test_make_mesh_rejects_uneven_hosts():
    with pytest.raises(ValueError):
        make_mesh(jax.devices()[:6], hosts=4)


def test_check_sharded_generated_graph():
    """__graft_entry__.check_sharded runs every sharded path on a
    generated graph and compares each with the single-device answer."""
    import bench
    from __graft_entry__ import check_sharded
    from pollen_tpu.device import build_device_graph

    g = bench.synth_graph(2**14, 2**10, 48, links=True)
    dg = build_device_graph(g, device="host")
    report, straddles = check_sharded(jax.devices()[:4], dg)
    names = [name for name, _, _ in report]
    assert names[:2] == ["scan", "scan-scatter"] and "degree" in names
    assert "cross" in names and "ell" in names
    assert straddles > 0


def test_sharded_residual_wrap_regression(mesh):
    """Clip-overflow residual columns owned by a LATER device must not
    wrap (negative scatter index) into an earlier-devices' column range
    (regression: mode='drop' drops past-the-end, negatives wrap)."""
    from pollen_tpu.flatgfa import GraphArrays
    from pollen_tpu.ops.depth import seg_depth_with_uniq_masked
    from pollen_tpu.parallel.sharded import (
        shard_cross_inputs,
        sharded_cross_depth_fn,
    )

    n_segs, n_paths = 1024, 4
    # Path 0: 20 crossings of segment 600 (overflows the nibble clip of
    # 15 -> residual sidecar col on device 600 // 128 = 4) + one step on
    # segment 0. Other paths: one step each on segment 0.
    segs = np.array([600] * 20 + [0, 0, 0, 0], np.uint32)
    steps = segs << np.uint32(1)
    path_steps = np.array(
        [[0, 21], [21, 22], [22, 23], [23, 24]], np.uint32
    )
    seg_lens = np.ones(n_segs, np.uint32)
    sb = np.concatenate(([0], np.cumsum(seg_lens))).astype(np.uint32)
    g = GraphArrays(
        header=np.zeros(0, np.uint8),
        seg_name=np.arange(1, n_segs + 1, dtype=np.int64),
        seg_seq=np.stack([sb[:-1], sb[1:]], axis=1),
        seg_optional=np.zeros((n_segs, 2), np.uint32),
        path_name=np.zeros((n_paths, 2), np.uint32),
        path_steps=path_steps,
        path_overlaps=np.zeros((n_paths, 2), np.uint32),
        link_from=np.zeros(0, np.uint32),
        link_to=np.zeros(0, np.uint32),
        steps=steps,
        link_overlap=np.zeros((0, 2), np.uint32),
        seq_data=np.zeros(int(sb[-1]), np.uint8),
        overlaps=np.zeros((0, 2), np.uint32),
        alignment=np.zeros(0, np.uint32),
        name_data=np.zeros(0, np.uint8),
        optional_data=np.zeros(0, np.uint8),
        line_order=np.zeros(0, np.uint8),
    )
    dg = build_device_graph(g)
    assert np.asarray(dg.cross_res_seg)[0] == 600  # overflow col exists
    sc = shard_cross_inputs(dg, mesh)
    assert sc is not None and 600 // sc.col_width > 0
    mask = jnp.ones(sc.num_paths_padded, jnp.int32).at[n_paths:].set(0)
    d_c, u_c = sharded_cross_depth_fn(mesh, nibble=sc.nibble)(
        sc.cross, sc.res, sc.res_seg, mask
    )
    d_ref, u_ref = seg_depth_with_uniq_masked(
        dg, jnp.ones(n_paths, bool)
    )
    np.testing.assert_array_equal(
        np.asarray(d_c)[:n_segs], np.asarray(d_ref)
    )
    np.testing.assert_array_equal(
        np.asarray(u_c)[:n_segs], np.asarray(u_ref)
    )


def test_sharded_ell_batch_matches_single(mesh):
    """Mesh-wide batched tiered-ELL queries (zero collectives) equal Q
    single-device masked queries, per class and in natural order."""
    import bench
    from pollen_tpu.parallel.sharded import (
        compose_ell_parts_natural,
        shard_ell_inputs,
        sharded_ell_depth_batch_fn,
    )

    _, dg = bench.synth_device_graph(2**14, 2**10, 48)
    se = shard_ell_inputs(dg, mesh)
    assert se is not None and se.heavy is not None
    rng = np.random.default_rng(53)
    q = 4
    masks = rng.integers(0, 2, (q, dg.num_paths)).astype(np.int32)
    has_mid = se.ell2 is not None
    has_mid2 = se.ell3 is not None
    args = [se.ell]
    if has_mid:
        args.append(se.ell2)
    if has_mid2:
        args.append(se.ell3)
    args += [se.heavy, se.heavy_res, se.heavy_res_col, jnp.asarray(masks)]
    parts = sharded_ell_depth_batch_fn(
        mesh, has_heavy=True, has_mid=has_mid, has_mid2=has_mid2
    )(*args)
    for i in range(q):
        parts_i = [p[i] for p in parts]
        d_nat, u_nat = compose_ell_parts_natural(
            dg, parts_i, has_mid=has_mid, has_heavy=True,
            has_mid2=has_mid2,
        )
        d_1, u_1 = depth_op.seg_depth_with_uniq_masked(
            dg, jnp.asarray(masks[i].astype(bool))
        )
        np.testing.assert_array_equal(d_nat, np.asarray(d_1))
        np.testing.assert_array_equal(u_nat, np.asarray(u_1))
