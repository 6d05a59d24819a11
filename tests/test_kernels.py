"""Masked-depth query forms vs brute force and dense NumPy references:
the step-level pipeline, the run-level index, the crossing matrix and
the tiered split ELL index (single and batched)."""

import numpy as np
import pytest
import jax.numpy as jnp

from pollen_tpu.device import (
    DeviceGraph,
    boundary_values,
    bounded_segment_sum,
    build_device_graph,
    first_in_group_mask,
)
from pollen_tpu.flatgfa import parse_gfa_file
from pollen_tpu.ops.depth import seg_depth_with_uniq_masked


def _random_case(s, p, n, seed):
    rng = np.random.default_rng(seed)
    seg = np.sort(rng.integers(0, n, s)).astype(np.int32)
    path = rng.integers(0, p, s).astype(np.int32)
    order = np.lexsort((path, seg))
    seg, path = seg[order], path[order]
    new = np.concatenate(
        ([True], (seg[1:] != seg[:-1]) | (path[1:] != path[:-1]))
    )
    starts = np.flatnonzero(new)
    run_start = starts[np.cumsum(new) - 1].astype(np.int32)
    bounds = np.searchsorted(seg, np.arange(n + 1)).astype(np.int32)
    return seg, path, run_start, bounds


def _step_pipeline(path, run_start, bounds, mask):
    """The masked step-level reductions seg_depth_with_uniq_masked runs
    (mask gather, cumsums, boundary gathers), on raw arrays."""
    w = jnp.asarray(mask)[jnp.asarray(path)]
    depth = bounded_segment_sum(w, jnp.asarray(bounds))
    first = first_in_group_mask(w, jnp.asarray(run_start))
    return depth, bounded_segment_sum(first, jnp.asarray(bounds))


def _brute_depth(g, mask):
    """(depth, uniq) per segment straight from the arena's path spans:
    a bincount over the steps of the selected paths, and over their
    distinct (segment, path) pairs."""
    segs = np.asarray(g.steps).astype(np.int64) >> 1
    paths = g.step_path_ids().astype(np.int64)
    sel = np.asarray(mask, bool)[paths]
    n = g.num_segments
    depth = np.bincount(segs[sel], minlength=n)
    pairs = np.unique(segs[sel] * (g.num_paths + 1) + paths[sel])
    uniq = np.bincount(pairs // (g.num_paths + 1), minlength=n)
    return depth, uniq


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("p", [60, 200, 2040, 2300])
def test_kernel_matches_bruteforce(seed, p):
    s, n = 16384, 37
    seg, path, run_start, bounds = _random_case(s, p, n, seed)
    rng = np.random.default_rng(seed + 100)
    mask = np.zeros(p + 1, np.int32)
    mask[:p] = rng.integers(0, 2, p)

    depth, uniq = _step_pipeline(path, run_start, bounds, mask)

    w = mask[path]
    for i in range(n):
        sel = slice(bounds[i], bounds[i + 1])
        assert depth[i] == w[sel].sum()
        assert uniq[i] == len(set(path[sel][w[sel] > 0]))


def test_kernel_group_spans_blocks():
    """One (segment, path) group spanning the whole step list."""
    s = 3 * 16384
    path = np.zeros(s, np.int32)
    run_start = np.zeros(s, np.int32)
    bounds = np.array([0, s], np.int32)
    mask = np.ones(2, np.int32)
    depth, uniq = _step_pipeline(path, run_start, bounds, mask)
    assert int(depth[0]) == s
    assert int(uniq[0]) == 1


def test_fused_path_matches_xla_on_fixture(graph_path):
    """The step-level pipeline on a fixture graph equals a bincount
    over the arena's raw path spans."""
    g = parse_gfa_file(str(graph_path))
    dg = build_device_graph(g)
    rng = np.random.default_rng(7)
    mask = rng.integers(0, 2, dg.num_paths).astype(bool)
    d_x, u_x = seg_depth_with_uniq_masked(dg, jnp.asarray(mask))
    d_b, u_b = _brute_depth(g, mask)
    np.testing.assert_array_equal(np.asarray(d_x), d_b)
    np.testing.assert_array_equal(np.asarray(u_x), u_b)


def test_cross_matrix_matches_xla(graph_path):
    """Crossing-matrix depth (masked column sums + clip sidecar) vs the
    masked-scan pipeline."""
    from pollen_tpu.ops.depth import seg_depth_with_uniq_cross

    g = parse_gfa_file(str(graph_path))
    dg = build_device_graph(g, cross_matrix="always")
    assert dg.cross_matrix.size
    rng = np.random.default_rng(13)
    for _ in range(2):
        mask = rng.integers(0, 2, dg.num_paths).astype(bool)
        d_x, u_x = seg_depth_with_uniq_masked(dg, jnp.asarray(mask))
        d_c, u_c = seg_depth_with_uniq_cross(dg, jnp.asarray(mask))
        np.testing.assert_array_equal(np.asarray(d_c), np.asarray(d_x))
        np.testing.assert_array_equal(np.asarray(u_c), np.asarray(u_x))


def test_cross_matrix_overflow_fixup():
    """A (path, segment) pair crossing more than CLIP times exercises
    the clip + dense residual sidecar."""
    from pollen_tpu.flatgfa import parse_gfa
    from pollen_tpu.kernels.crossmat import RES_SENTINEL
    from pollen_tpu.ops.depth import seg_depth_with_uniq_cross

    steps = ",".join(["1+", "2-"] * 300)
    text = (
        f"S\t1\tAC\nS\t2\tGG\nS\t3\tT\n"
        f"P\tbig\t{steps}\t*\nP\tsmall\t3+,1-\t*\n"
    ).encode()
    dg = build_device_graph(parse_gfa(text), cross_matrix="always")
    # Both segment 1 and 2 overflow the clip into the sidecar.
    assert int((np.asarray(dg.cross_res_seg) < RES_SENTINEL).sum()) == 2
    for mask in ([1, 1], [1, 0], [0, 1], [0, 0]):
        m = jnp.asarray(np.array(mask, bool))
        d_c, u_c = seg_depth_with_uniq_cross(dg, m)
        d_x, u_x = seg_depth_with_uniq_masked(dg, m)
        np.testing.assert_array_equal(np.asarray(d_c), np.asarray(d_x))
        np.testing.assert_array_equal(np.asarray(u_c), np.asarray(u_x))


def test_ell_matches_xla(graph_path):
    """Split ELL run depth (natural and permuted layouts) vs the
    masked-scan pipeline, and each stored tier (pack16-aware) vs the
    unpaired 32-bit slot reduction."""
    from pollen_tpu.kernels.ellscan import (
        masked_ell_depth_xla,
        pack_mask_words,
        tier_depth,
        unpair_ell16,
    )
    from pollen_tpu.ops.depth import (
        seg_depth_with_uniq_ell,
        seg_depth_with_uniq_ell_permuted,
    )

    g = parse_gfa_file(str(graph_path))
    dg = build_device_graph(g, cross_matrix="always")
    assert dg.cross_ell.size
    n = dg.num_segments
    rng = np.random.default_rng(23)
    for _ in range(2):
        mask = rng.integers(0, 2, dg.num_paths).astype(bool)
        d_x, u_x = seg_depth_with_uniq_masked(dg, jnp.asarray(mask))
        d_e, u_e = seg_depth_with_uniq_ell(dg, jnp.asarray(mask))
        np.testing.assert_array_equal(np.asarray(d_e), np.asarray(d_x))
        np.testing.assert_array_equal(np.asarray(u_e), np.asarray(u_x))

        # The permuted pair + ell_order reconstructs natural order.
        d_p, u_p = seg_depth_with_uniq_ell_permuted(dg, jnp.asarray(mask))
        if dg.ell_order.shape[0]:
            order = np.asarray(dg.ell_order)
            d_nat = np.empty(n, np.int64)
            u_nat = np.empty(n, np.int64)
            d_nat[order] = np.asarray(d_p)[:n]
            u_nat[order] = np.asarray(u_p)[:n]
        else:
            d_nat, u_nat = np.asarray(d_p)[:n], np.asarray(u_p)[:n]
        np.testing.assert_array_equal(d_nat, np.asarray(d_x))
        np.testing.assert_array_equal(u_nat, np.asarray(u_x))

        m32 = jnp.asarray(mask.astype(np.int32))
        flat = (
            unpair_ell16(dg.cross_ell) if dg.ell_pack16 else dg.cross_ell
        )
        d_k, u_k = tier_depth(dg.cross_ell, m32, pack16=bool(dg.ell_pack16))
        d_k2, u_k2 = masked_ell_depth_xla(flat, m32)
        np.testing.assert_array_equal(np.asarray(d_k), np.asarray(d_k2))
        np.testing.assert_array_equal(np.asarray(u_k), np.asarray(u_k2))
    # Mask-word packing round trip.
    words = np.asarray(pack_mask_words(jnp.asarray(mask.astype(np.int32)), -(-dg.num_paths // 32)))
    bits = [(int(words[p // 32]) >> (p % 32)) & 1 for p in range(dg.num_paths)]
    np.testing.assert_array_equal(np.array(bits, bool), mask)


@pytest.mark.parametrize("nibble", [True, False])
def test_cross_xla_matches_dense_reference(nibble):
    """masked_cross_depth_xla and batched_cross_depth equal a dense
    NumPy masked column sum over the unpacked matrix."""
    from pollen_tpu.kernels.crossmat import (
        batched_cross_depth,
        masked_cross_depth_xla,
    )

    rng = np.random.default_rng(53)
    n_pad, p_pad = 1024, 128
    if nibble:
        a = rng.integers(0, 256, (p_pad // 2, n_pad)).astype(np.uint8)
        dense = np.zeros((p_pad, n_pad), np.int64)
        dense[0::2] = a & 15
        dense[1::2] = a >> 4
    else:
        a = rng.integers(0, 100, (p_pad, n_pad)).astype(np.int8)
        dense = a.astype(np.int64)
    masks = rng.integers(0, 2, (3, p_pad)).astype(np.int32)
    d_b, u_b = batched_cross_depth(
        jnp.asarray(a), jnp.asarray(masks), nibble=nibble
    )
    for q in range(3):
        d, u = masked_cross_depth_xla(
            jnp.asarray(a), jnp.asarray(masks[q]), nibble=nibble
        )
        np.testing.assert_array_equal(np.asarray(d), masks[q] @ dense)
        np.testing.assert_array_equal(np.asarray(u), masks[q] @ (dense > 0))
        np.testing.assert_array_equal(np.asarray(d_b)[q], masks[q] @ dense)
        np.testing.assert_array_equal(
            np.asarray(u_b)[q], masks[q] @ (dense > 0)
        )


def test_plan_ell_tiers_properties():
    """Fuzz the tier planner's invariants: the classes partition the
    crossed segments, tier members fit their slot counts, big-count
    segments always go heavy, and tier-1 is nonempty whenever any
    crossed segment fits some K."""
    from pollen_tpu.kernels.ellscan import plan_ell_tiers

    rng = np.random.default_rng(71)
    for _ in range(20):
        n = int(rng.integers(1, 5000))
        rps = rng.zipf(1.5, size=n).astype(np.int64) - 1
        big = rng.random(n) < 0.01
        big &= rps > 0
        p_pad = int(rng.choice([128, 256, 1024]))
        k1, k2, t1, t2, heavy = plan_ell_tiers(rps, big, p_pad)
        crossed = rps > 0
        # Partition: disjoint, union == crossed minus nothing.
        assert not (t1 & t2).any()
        assert not (t1 & heavy).any()
        assert not (t2 & heavy).any()
        np.testing.assert_array_equal(t1 | t2 | heavy, crossed)
        # Members fit their slots; big counts are never tiered.
        assert (rps[t1] <= k1).all()
        if k2:
            assert (rps[t2] > k1).all() and (rps[t2] <= k2).all()
        else:
            assert not t2.any()
        assert not (t1 & big).any() and not (t2 & big).any()
        if (crossed & ~big & (rps <= 16)).any():
            assert t1.any()


def test_plan_ell_tiers_no_empty_tier1():
    """A degenerate distribution (every crossed segment has exactly 2
    runs) must not tie-break into a plan with an empty tier-1 — the
    ingest gate would then drop the whole index (regression)."""
    from pollen_tpu.kernels.ellscan import plan_ell_tiers

    rps = np.full(1000, 2, np.int64)
    big = np.zeros(1000, bool)
    k1, k2, t1, t2, heavy = plan_ell_tiers(rps, big, 128)
    assert t1.any(), "tier-1 must hold the fitting segments"
    assert t1.sum() + t2.sum() + heavy.sum() == 1000
    assert not heavy.any()


def _random_tier(rng, k, n_cols, p, max_count):
    """Random runs packed into int32[K, n_cols] ELL slots (at most k
    runs per column)."""
    from pollen_tpu.kernels.ellscan import pack_ell

    run_col = np.sort(rng.integers(0, n_cols, 2 * n_cols))
    slot = np.arange(run_col.size) - np.searchsorted(run_col, run_col)
    keep = slot < k
    run_col, slot = run_col[keep], slot[keep]
    run_path = rng.integers(0, p, run_col.size).astype(np.int32)
    run_count = rng.integers(1, max_count + 1, run_col.size).astype(np.int32)
    return pack_ell(run_path, run_count, run_col, slot, k, n_cols)


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_ell_pair16_roundtrip(k):
    """unpair_ell16 inverts pair_ell16 up to slot order: per column the
    multiset of nonzero slots survives (odd K pads a zero half)."""
    from pollen_tpu.kernels.ellscan import pair_ell16, unpair_ell16

    rng = np.random.default_rng(67 + k)
    ell = _random_tier(rng, k, 1000, 200, 255)
    paired = pair_ell16(ell)
    assert paired.shape == ((k + 1) // 2, 1000)
    back = unpair_ell16(paired)
    np.testing.assert_array_equal(
        np.sort(back, axis=0)[-k:], np.sort(ell, axis=0)
    )
    assert not np.sort(back, axis=0)[:-k].any()


def test_ell_split_fused_kernel():
    """Every piece of the split query — tier slot reductions (32-bit
    and pack16) and the heavy nibble column sums — equals the dense
    reference."""
    from pollen_tpu.kernels.crossmat import masked_cross_depth_xla
    from pollen_tpu.kernels.ellscan import pair_ell16, tier_depth

    t1, t2, hm, c1, c2, ch = _synth_ell_split(seed=59, p=100, k=2, k2=4)
    rng = np.random.default_rng(59)
    mask = rng.integers(0, 2, 100).astype(np.int32)
    mref = np.zeros(128, np.int64)
    mref[:100] = mask
    for tier, cls in ((t1, c1), (t2, c2)):
        for pack16 in (False, True):
            if pack16 and (cls > 255).any():
                continue
            stored = pair_ell16(tier) if pack16 else tier
            d, u = tier_depth(jnp.asarray(stored), jnp.asarray(mask),
                              pack16=pack16)
            np.testing.assert_array_equal(
                np.asarray(d)[: cls.shape[1]], mref @ cls
            )
            np.testing.assert_array_equal(
                np.asarray(u)[: cls.shape[1]], mref @ (cls > 0)
            )
    dh, uh = masked_cross_depth_xla(
        jnp.asarray(hm), jnp.asarray(mref.astype(np.int32)), nibble=True
    )
    np.testing.assert_array_equal(np.asarray(dh)[: ch.shape[1]], mref @ ch)
    np.testing.assert_array_equal(
        np.asarray(uh)[: ch.shape[1]], mref @ (ch > 0)
    )


def test_ell_tiered_split_end_to_end(monkeypatch):
    """A graph with many 1-run segments, a band of mid-popularity
    segments, and never-crossed segments makes the planner build a
    tier-2 class and an empty class; every query form stays exact.
    (The per-column/fixed costs merge tiers at this CPU fixture size,
    so they are zeroed — the point here is multi-tier EXACTNESS, not
    the production plan.)"""
    from pollen_tpu.kernels import ellscan

    monkeypatch.setattr(ellscan, "C_TIER_FIXED", 0.0)
    monkeypatch.setattr(ellscan, "C_COL_B", 0.0)
    from pollen_tpu.ops.depth import (
        seg_depth_with_uniq_ell,
        seg_depth_with_uniq_ell_parts,
        seg_depth_with_uniq_ell_permuted,
        seg_depth_with_uniq_masked,
    )

    n_light, n_mid, n_empty, p = 30000, 20000, 5000, 30
    n_segs = n_light + n_mid + n_empty
    pairs = []  # (path, seg)
    for i in range(n_light):  # 1 run each
        pairs.append((i % p, i))
    for i in range(n_mid):  # 6 distinct paths each
        for d in range(6):
            pairs.append(((i + d * 7) % p, n_light + i))
    pairs.sort()
    path_ids = np.array([pp for pp, _ in pairs], np.int64)
    seg_ids = np.array([s for _, s in pairs], np.uint32)
    counts = np.bincount(path_ids, minlength=p)
    bounds = np.concatenate(([0], np.cumsum(counts))).astype(np.uint32)
    from pollen_tpu.flatgfa import GraphArrays

    seq_bounds = np.arange(n_segs + 1, dtype=np.uint32)
    g = GraphArrays(
        header=np.zeros(0, np.uint8),
        seg_name=np.arange(1, n_segs + 1, dtype=np.int64),
        seg_seq=np.stack([seq_bounds[:-1], seq_bounds[1:]], axis=1),
        seg_optional=np.zeros((n_segs, 2), np.uint32),
        path_name=np.zeros((p, 2), np.uint32),
        path_steps=np.stack([bounds[:-1], bounds[1:]], axis=1),
        path_overlaps=np.zeros((p, 2), np.uint32),
        link_from=np.zeros(0, np.uint32),
        link_to=np.zeros(0, np.uint32),
        link_overlap=np.zeros((0, 2), np.uint32),
        steps=seg_ids << np.uint32(1),
        seq_data=np.zeros(n_segs, np.uint8),
        overlaps=np.zeros((0, 2), np.uint32),
        alignment=np.zeros(0, np.uint32),
        name_data=np.zeros(0, np.uint8),
        optional_data=np.zeros(0, np.uint8),
        line_order=np.zeros(0, np.uint8),
    )
    dg = build_device_graph(g, cross_matrix="always")
    assert dg.ell_k2 > 0 and dg.cross_ell2.size
    assert dg.ell_num_mid > 0
    assert (
        dg.ell_num_light + dg.ell_num_mid + dg.ell_num_heavy
        < dg.num_segments
    ), "expected a non-empty empty class"
    assert dg.ell_order.shape[0] == dg.num_segments

    rng = np.random.default_rng(61)
    n = dg.num_segments
    for _ in range(2):
        mask = rng.integers(0, 2, dg.num_paths).astype(bool)
        d_x, u_x = seg_depth_with_uniq_masked(dg, jnp.asarray(mask))
        # Natural-order host composition.
        d_e, u_e = seg_depth_with_uniq_ell(dg, jnp.asarray(mask))
        np.testing.assert_array_equal(np.asarray(d_e), np.asarray(d_x))
        np.testing.assert_array_equal(np.asarray(u_e), np.asarray(u_x))
        # Permuted device form + inverse permutation.
        d_p, u_p = seg_depth_with_uniq_ell_permuted(dg, jnp.asarray(mask))
        order = np.asarray(dg.ell_order)
        d_nat = np.empty(n, np.int64)
        u_nat = np.empty(n, np.int64)
        d_nat[order] = np.asarray(d_p)[:n]
        u_nat[order] = np.asarray(u_p)[:n]
        np.testing.assert_array_equal(d_nat, np.asarray(d_x))
        np.testing.assert_array_equal(u_nat, np.asarray(u_x))
        # Raw parts carry a real tier-2 pair.
        parts = seg_depth_with_uniq_ell_parts(dg, jnp.asarray(mask))
        assert parts[2] is not None and parts[3] is not None


def test_ell_heavy_segments_sidecar():
    """Segments with more runs than K slots split into the heavy
    nibble sub-matrix (with clip residual); depth AND uniq exact."""
    from pollen_tpu.kernels.ellscan import build_ell
    from pollen_tpu.ops.depth import seg_depth_with_uniq_ell

    # Segment 1 crossed by 40 paths (40 runs — heavy for small K), and
    # path p0 crosses segment 1 twenty times (count 21 > 15: exercises
    # the heavy nibble clip residual too).
    lines = ["S\t1\tAA"] + [f"S\t{i}\tC" for i in range(2, 40)]
    lines += [
        "P\tp0\t" + ",".join(["1+"] * 20) + ",2+\t*"
    ]
    lines += [f"P\tp{j}\t1+,{2 + (j % 38)}+\t*" for j in range(1, 40)]
    text = ("\n".join(lines) + "\n").encode()
    from pollen_tpu.flatgfa import parse_gfa

    g = parse_gfa(text)
    dg = build_device_graph(g, cross_matrix="always")
    assert dg.cross_ell.size
    # Heavy split present: permutation covers all segments, the heavy
    # nibble matrix exists, and the clip residual caught count 21.
    assert dg.ell_heavy.size
    assert dg.ell_order.shape[0] == dg.num_segments
    assert dg.ell_num_light < dg.num_segments
    assert dg.ell_heavy_res_col.size
    # Invariant the query's slice-add fixup relies on: the residual
    # columns occupy the heavy block's prefix, in order.
    res_cols = np.asarray(dg.ell_heavy_res_col)
    real = res_cols[res_cols < 2**30]
    np.testing.assert_array_equal(real, np.arange(real.size))
    rng = np.random.default_rng(7)
    for _ in range(3):
        mask = rng.integers(0, 2, dg.num_paths).astype(bool)
        mask[0] = True  # keep the clip-residual path in play
        d_x, u_x = seg_depth_with_uniq_masked(dg, jnp.asarray(mask))
        d_e, u_e = seg_depth_with_uniq_ell(dg, jnp.asarray(mask))
        np.testing.assert_array_equal(np.asarray(d_e), np.asarray(d_x))
        np.testing.assert_array_equal(np.asarray(u_e), np.asarray(u_x))
    # Direct build_ell with forced K=1: the two-run segment overflows.
    ell, heavy = build_ell(
        np.array([0, 1, 0], np.int32),  # paths
        np.array([2, 1, 70000], np.int32),  # counts (one > 16 bits)
        np.array([0, 0, 1], np.int32),  # segments (grouped)
        num_segments=2,
        k=1,
    )
    assert ell.shape[0] == 1
    # Segment 0 has 2 runs (> K) and segment 1 a count overflow: both heavy.
    np.testing.assert_array_equal(heavy, [0, 1])
    assert not ell[:, :2].any()


def test_boundary_values_matches_numpy(graph_path):
    """The boundary gather (and boundary differences) over a fixture
    graph's sorted-index bounds equal the NumPy exclusive-cumsum
    lookup."""
    from pollen_tpu.device import boundary_diff

    g = parse_gfa_file(str(graph_path))
    dg = build_device_graph(g)
    bounds = np.asarray(dg.seg_bounds)
    rng = np.random.default_rng(31)
    csum_np = np.cumsum(
        rng.integers(0, 3, bounds[-1] + 5).astype(np.int32)
    ).astype(np.int32)
    want = np.concatenate(([0], csum_np))[bounds]
    got = boundary_values(jnp.asarray(csum_np), jnp.asarray(bounds))
    np.testing.assert_array_equal(np.asarray(got), want)
    diff = boundary_diff(jnp.asarray(csum_np), jnp.asarray(bounds))
    np.testing.assert_array_equal(np.asarray(diff), np.diff(want))


def test_boundary_values_edges():
    """Bounds at 0 and at the very end, repeated bounds (empty ranges)
    and an empty cumsum."""
    csum = np.arange(1, 9, dtype=np.int32)  # inclusive cumsum of ones
    bounds = np.array([0, 0, 3, 3, 8], np.int32)
    got = boundary_values(jnp.asarray(csum), jnp.asarray(bounds))
    np.testing.assert_array_equal(np.asarray(got), [0, 0, 3, 3, 8])
    empty = boundary_values(
        jnp.zeros(0, jnp.int32), jnp.zeros(3, jnp.int32)
    )
    np.testing.assert_array_equal(np.asarray(empty), [0, 0, 0])


def test_ell_high_path_ids():
    """Path ids >= 2**15 set the packed word's sign bit; the slot
    reductions must zero-extend (``(v >> 16) & 0xFFFF``), not
    sign-extend (regression: sign-extension returned silently wrong
    depth/uniq)."""
    from pollen_tpu.kernels.ellscan import build_ell, masked_ell_depth_xla

    paths = np.array([5, 32768, 40000, 65535], np.int32)
    counts = np.array([3, 7, 2, 1], np.int32)
    segs = np.array([0, 0, 1, 2], np.int32)
    ell, heavy = build_ell(paths, counts, segs, num_segments=128, k=2)
    assert heavy.size == 0
    rng = np.random.default_rng(11)
    for _ in range(3):
        mask = rng.integers(0, 2, 65536).astype(np.int32)
        want_d = np.zeros(128, np.int64)
        want_u = np.zeros(128, np.int64)
        for p, c, s in zip(paths, counts, segs):
            want_d[s] += mask[p] * c
            want_u[s] += mask[p]
        d, u = masked_ell_depth_xla(jnp.asarray(ell), jnp.asarray(mask))
        np.testing.assert_array_equal(np.asarray(d)[:128], want_d)
        np.testing.assert_array_equal(np.asarray(u)[:128], want_u)


def test_cross_matrix_batch(graph_path):
    from pollen_tpu.ops.depth import (
        seg_depth_with_uniq_batch,
        seg_depth_with_uniq_masked,
    )

    g = parse_gfa_file(str(graph_path))
    dg = build_device_graph(g, cross_matrix="always")
    rng = np.random.default_rng(17)
    masks = rng.integers(0, 2, (4, dg.num_paths)).astype(bool)
    d_b, u_b = seg_depth_with_uniq_batch(dg, jnp.asarray(masks))
    for q in range(masks.shape[0]):
        d_x, u_x = seg_depth_with_uniq_masked(dg, jnp.asarray(masks[q]))
        np.testing.assert_array_equal(np.asarray(d_b[q]), np.asarray(d_x))
        np.testing.assert_array_equal(np.asarray(u_b[q]), np.asarray(u_x))


def test_cross_matrix_batch_pallas(graph_path):
    """The Q-mask crossing-matrix matmul equals Q single masked column
    sums on a fixture graph's matrix."""
    from pollen_tpu.kernels.crossmat import (
        batched_cross_depth,
        masked_cross_depth_xla,
    )

    g = parse_gfa_file(str(graph_path))
    dg = build_device_graph(g, cross_matrix="always")
    p_pad = dg.cross_matrix.shape[0] * (2 if dg.cross_nibble else 1)
    rng = np.random.default_rng(23)
    masks = np.zeros((5, p_pad), np.int32)
    masks[:, : dg.num_paths] = rng.integers(0, 2, (5, dg.num_paths))
    d_b, u_b = batched_cross_depth(
        dg.cross_matrix, jnp.asarray(masks), nibble=dg.cross_nibble
    )
    for q in range(5):
        d_1, u_1 = masked_cross_depth_xla(
            dg.cross_matrix, jnp.asarray(masks[q]), nibble=dg.cross_nibble
        )
        np.testing.assert_array_equal(np.asarray(d_b)[q], np.asarray(d_1))
        np.testing.assert_array_equal(np.asarray(u_b)[q], np.asarray(u_1))


def test_run_level_kernel_matches_xla(graph_path):
    """The run-level query vs a brute-force sum over the run arrays
    and vs the step-level pipeline."""
    from pollen_tpu.ops.depth import seg_depth_with_uniq_runs

    g = parse_gfa_file(str(graph_path))
    dg = build_device_graph(g)
    run_path = np.asarray(dg.run_path)
    run_count = np.asarray(dg.run_count)
    b = np.asarray(dg.run_seg_bounds)
    rng = np.random.default_rng(11)
    for _ in range(2):
        mask = rng.integers(0, 2, dg.num_paths).astype(bool)
        w = mask[run_path].astype(np.int64)
        depth_b = np.array(
            [(w * run_count)[b[i] : b[i + 1]].sum() for i in range(b.size - 1)]
        )
        uniq_b = np.array([w[b[i] : b[i + 1]].sum() for i in range(b.size - 1)])
        d_r, u_r = seg_depth_with_uniq_runs(dg, jnp.asarray(mask))
        d_x, u_x = seg_depth_with_uniq_masked(dg, jnp.asarray(mask))
        np.testing.assert_array_equal(np.asarray(d_r), depth_b)
        np.testing.assert_array_equal(np.asarray(u_r), uniq_b)
        np.testing.assert_array_equal(np.asarray(d_r), np.asarray(d_x))
        np.testing.assert_array_equal(np.asarray(u_r), np.asarray(u_x))


def _synth_ell_split(seed=0, p=48, nl=300, nm=90, nh=40, k=2, k2=4):
    """Synthetic tiered split arrays (flat tiers + heavy nibble matrix)
    plus dense reference crossing count matrices."""
    from pollen_tpu.kernels.crossmat import CLIP_NIBBLE
    from pollen_tpu.kernels.ellscan import pack_ell

    rng = np.random.default_rng(seed)
    p_pad = 128
    # Reference counts per (path, col) for each class.
    def make_counts(cols, max_runs, max_count):
        c = np.zeros((p_pad, cols), np.int64)
        for j in range(cols):
            n_runs = rng.integers(1, max_runs + 1)
            paths = rng.choice(p, size=n_runs, replace=False)
            c[paths, j] = rng.integers(1, max_count + 1, n_runs)
        return c

    c1 = make_counts(nl, k, 60000)
    c2 = make_counts(nm, k2, 9)
    ch = make_counts(nh, min(p, 30), 12)  # counts <= CLIP_NIBBLE

    def to_flat(c, kk):
        pathc, colc = np.nonzero(c.T)[1], np.nonzero(c.T)[0]
        order = np.argsort(colc, kind="stable")
        pathc, colc = pathc[order], colc[order]
        cnt = c[pathc, colc]
        slot = np.zeros_like(colc)
        for j in range(c.shape[1]):
            idx = np.flatnonzero(colc == j)
            slot[idx] = np.arange(idx.size)
        return pack_ell(pathc, cnt, colc, slot, kk, c.shape[1])

    t1 = to_flat(c1, k)
    t2 = to_flat(c2, k2)
    hm = np.zeros((p_pad // 2, -(-nh // 128) * 128), np.uint8)
    hp, hc = np.nonzero(ch)
    vals = np.minimum(ch[hp, hc], CLIP_NIBBLE).astype(np.uint8)
    even = (hp & 1) == 0
    hm[hp[even] >> 1, hc[even]] = vals[even]
    hm[hp[~even] >> 1, hc[~even]] |= vals[~even] << 4
    return t1, t2, hm, c1, c2, np.minimum(ch, CLIP_NIBBLE)


def _split_graph(p, tiers, heavy, ks):
    """A DeviceGraph holding only a split ELL index (``tiers`` flat,
    ``heavy`` nibble-packed): enough for the ELL query forms."""
    e32 = np.zeros(0, np.int32)
    stored = list(tiers) + [np.zeros((0, 0), np.int32)] * (3 - len(tiers))
    cols = [t.shape[1] for t in tiers] + [0] * (3 - len(tiers))
    return DeviceGraph(
        steps=np.zeros(0, np.uint32), step_path=e32, path_bounds=e32,
        seg_len=e32, link_from=np.zeros(0, np.uint32),
        link_to=np.zeros(0, np.uint32), perm=e32, step_path_sorted=e32,
        seg_bounds=e32, run_start=e32, run_path=e32, run_count=e32,
        run_seg_bounds=e32, link_seg_bounds=e32,
        cross_matrix=np.zeros((0, 0), np.int8),
        cross_res=np.zeros((0, 0), np.int32), cross_res_seg=e32,
        cross_ell=stored[0], cross_ell2=stored[1], cross_ell3=stored[2],
        ell_order=e32, ell_heavy=heavy,
        ell_heavy_res=np.zeros((0, 0), np.int32), ell_heavy_res_col=e32,
        num_segments=sum(cols) + heavy.shape[1], num_paths=p,
        ell_num_light=cols[0], ell_num_mid=cols[1], ell_num_mid2=cols[2],
        ell_num_heavy=heavy.shape[1],
        ell_k=ks[0], ell_k2=(list(ks) + [0, 0])[1],
        ell_k3=(list(ks) + [0, 0])[2],
    )


def _check_batch_parts(outs, classes, masks):
    mref = np.zeros((masks.shape[0], 128), np.int64)
    mref[:, : masks.shape[1]] = masks
    for cls, (d, u) in zip(classes, zip(outs[0::2], outs[1::2])):
        cols = cls.shape[1]
        np.testing.assert_array_equal(np.asarray(d)[:, :cols], mref @ cls)
        np.testing.assert_array_equal(
            np.asarray(u)[:, :cols], mref @ (cls > 0)
        )


@pytest.mark.parametrize("q", [1, 5, 8])
def test_ell_batch_kernel_matches_reference(q):
    """The batched split query (tier reductions vmapped over the
    masks, heavy class as one matmul) equals the dense per-query
    reference on all three classes, including a ragged Q."""
    from pollen_tpu.ops.depth import seg_depth_with_uniq_ell_batch_parts

    k, k2, p = 2, 4, 48
    t1, t2, hm, c1, c2, ch = _synth_ell_split(seed=3, p=p, k=k, k2=k2)
    dg = _split_graph(p, (t1, t2), hm, (k, k2))
    rng = np.random.default_rng(9)
    masks = rng.integers(0, 2, (q, p)).astype(np.int32)
    outs = seg_depth_with_uniq_ell_batch_parts(dg, jnp.asarray(masks))
    _check_batch_parts(outs, (c1, c2, ch), masks)


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_ell_pack16_matches_unpacked(k):
    """The 16-bit paired slot layout (two path<<8|count halves per
    int32 word; pack16=True) answers identically to the standard
    32-bit layout, for odd and even K (odd K pads a zero half), single
    and vmapped over a batch of masks."""
    import jax

    from pollen_tpu.kernels.ellscan import (
        masked_ell_depth_xla,
        pair_ell16,
        tier_depth,
    )

    rng = np.random.default_rng(31)
    p = 100  # paths < 256, counts <= 255
    ell = _random_tier(rng, k, 4096, p, 255)
    ell16 = pair_ell16(ell)
    mask = rng.integers(0, 2, p).astype(np.int32)
    d_x, u_x = masked_ell_depth_xla(jnp.asarray(ell), jnp.asarray(mask))
    d, u = tier_depth(jnp.asarray(ell16), jnp.asarray(mask), pack16=True)
    np.testing.assert_array_equal(np.asarray(d), np.asarray(d_x))
    np.testing.assert_array_equal(np.asarray(u), np.asarray(u_x))

    masks = rng.integers(0, 2, (5, p)).astype(np.int32)
    db, ub = jax.vmap(
        lambda m: tier_depth(jnp.asarray(ell16), m, pack16=True)
    )(jnp.asarray(masks))
    for i in range(5):
        di, ui = masked_ell_depth_xla(jnp.asarray(ell), jnp.asarray(masks[i]))
        np.testing.assert_array_equal(np.asarray(db)[i], np.asarray(di))
        np.testing.assert_array_equal(np.asarray(ub)[i], np.asarray(ui))


@pytest.mark.parametrize("q", [4, 16])
def test_ell_batch_split_three_tiers(q):
    """A three-tier batched split query (tier 3 folded into the mid
    pair) equals the dense per-query reference on all four classes."""
    from pollen_tpu.ops.depth import seg_depth_with_uniq_ell_batch_parts

    k, k2, k3, p = 1, 4, 16, 48
    t1, t2, hm, c1, c2, ch = _synth_ell_split(seed=11, p=p, k=k, k2=k2)
    t3, _, _, c3, _, _ = _synth_ell_split(seed=12, p=p, k=k3)
    dg = _split_graph(p, (t1, t2, t3), hm, (k, k2, k3))
    rng = np.random.default_rng(21)
    masks = rng.integers(0, 2, (q, p)).astype(np.int32)
    d1, u1, d2, u2, dh, uh = seg_depth_with_uniq_ell_batch_parts(
        dg, jnp.asarray(masks)
    )
    assert d2.shape[1] == t2.shape[1] + t3.shape[1]
    _check_batch_parts(
        (d1, u1, d2, u2, dh, uh),
        (c1, np.concatenate([c2, c3], axis=1), ch),
        masks,
    )


def test_ell_batch_kernel_no_mid_no_heavy():
    """Batched query with only tier-1 present."""
    from pollen_tpu.ops.depth import seg_depth_with_uniq_ell_batch_parts

    k, p = 2, 48
    t1, _, _, c1, _, _ = _synth_ell_split(seed=5, p=p, k=k)
    dg = _split_graph(p, (t1,), np.zeros((0, 0), np.uint8), (k,))
    rng = np.random.default_rng(2)
    masks = rng.integers(0, 2, (3, p)).astype(np.int32)
    d1, u1, d2, u2, dh, uh = seg_depth_with_uniq_ell_batch_parts(
        dg, jnp.asarray(masks)
    )
    assert d2 is None and dh is None
    _check_batch_parts((d1, u1), (c1,), masks)


@pytest.mark.parametrize("nh_pad", [65536, 16384])
def test_heavy_nibble_widths(nh_pad):
    """The heavy class's single-query masked column sums at wide
    blocks equal the dense reference (the batched matmul too)."""
    from pollen_tpu.kernels.crossmat import (
        batched_cross_depth,
        masked_cross_depth_xla,
    )

    rng = np.random.default_rng(61)
    p_pad = 128
    heavy = rng.integers(0, 256, (p_pad // 2, nh_pad)).astype(np.uint8)
    dense = np.zeros((p_pad, nh_pad), np.int64)
    dense[0::2] = heavy & 15
    dense[1::2] = heavy >> 4
    mask = rng.integers(0, 2, p_pad).astype(np.int32)
    dh, uh = masked_cross_depth_xla(
        jnp.asarray(heavy), jnp.asarray(mask), nibble=True
    )
    np.testing.assert_array_equal(np.asarray(dh), mask @ dense)
    np.testing.assert_array_equal(np.asarray(uh), mask @ (dense > 0))
    db, ub = batched_cross_depth(
        jnp.asarray(heavy), jnp.asarray(mask[None]), nibble=True
    )
    np.testing.assert_array_equal(np.asarray(db)[0], mask @ dense)
    np.testing.assert_array_equal(np.asarray(ub)[0], mask @ (dense > 0))


@pytest.mark.gpu
def test_masked_routes_on_gpu(gpu):
    """Every masked-depth route, compiled for the GPU, equals the
    arena bincount on a Zipf graph with ELL, heavy and matrix classes."""
    import bench
    from pollen_tpu.ops import depth as D

    g = bench.synth_graph(2**16, 2**12, 96)
    dg = build_device_graph(g, cross_matrix="always")
    mask = np.random.default_rng(3).integers(0, 2, 96).astype(bool)
    want = _brute_depth(g, mask)
    for impl in ("ell", "cross", "runs", "xla"):
        got = D._MASKED_IMPLS[impl](dg, jnp.asarray(mask))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(np.asarray(a), b, impl)
