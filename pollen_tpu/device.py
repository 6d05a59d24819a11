"""Device-resident graph tensors and ingest-time precomputation.

At ingest we move the arena's hot pools into device memory **plus a
sort-based index** that turns every histogram-style query (depth,
degree, matrix, ...) into dense, coalesced work:

* ``perm`` — a permutation of step indices sorted by (segment, path).
* ``seg_bounds`` — where each segment's run begins/ends in that order.
* ``run_start`` — for each sorted position, the position where its
  (segment, path) group begins.

With these, a masked segment-sum is gather → cumsum → one boundary
gather: bandwidth-bound streaming ops with *no scatter* and no
data-dependent control flow (the reference instead walks path spans
and increments counters in place; reference:
flatgfa/src/ops/depth.rs:15-39). The sort is paid once per graph load
and amortized over every query.

``DeviceGraph`` is a registered pytree so it can flow through ``jit``
and ``shard_map`` unchanged.
"""

from __future__ import annotations

import dataclasses
import os
from functools import partial

import jax

# Exact integer accumulation (bp-weighted path sums) needs int64 on
# device; all hot-path arrays still use explicit 32-bit dtypes.
jax.config.update("jax_enable_x64", True)

# Persistent compile cache used when JAX_COMPILATION_CACHE_DIR is not
# set: a fixed path inside the checkout, because the path is part of
# the cache key — a directory that moves never hits.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def _enable_compile_cache() -> None:
    """Repeated invocations over the same shapes skip recompilation.
    JAX reads JAX_COMPILATION_CACHE_DIR itself; only without it does
    this set the directory."""
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


_enable_compile_cache()

import jax.numpy as jnp
import numpy as np

from .flatgfa import GraphArrays


def on_gpu() -> bool:
    """Whether JAX's default backend is a GPU — the one backend
    predicate of the package (device choice itself is JAX's, through
    JAX_PLATFORMS)."""
    return jax.default_backend() == "gpu"


@partial(
    jax.tree_util.register_dataclass,
    data_fields=[
        "steps",
        "step_path",
        "path_bounds",
        "seg_len",
        "link_from",
        "link_to",
        "perm",
        "step_path_sorted",
        "seg_bounds",
        "run_start",
        "run_path",
        "run_count",
        "run_seg_bounds",
        "link_seg_bounds",
        "cross_matrix",
        "cross_res",
        "cross_res_seg",
        "cross_ell",
        "cross_ell2",
        "cross_ell3",
        "ell_order",
        "ell_heavy",
        "ell_heavy_res",
        "ell_heavy_res_col",
    ],
    meta_fields=[
        "num_segments",
        "num_paths",
        "cross_nibble",
        "ell_num_light",
        "ell_num_mid",
        "ell_num_mid2",
        "ell_num_heavy",
        "ell_k",
        "ell_k2",
        "ell_k3",
        "ell_pack16",
    ],
)
@dataclasses.dataclass
class DeviceGraph:
    """The queryable graph, resident in device memory."""

    # Natural (path) order.
    steps: jax.Array  # uint32[S] packed handles
    step_path: jax.Array  # int32[S] owning path per step
    path_bounds: jax.Array  # int32[P+1] step-span boundaries per path
    seg_len: jax.Array  # int32[N] bp length per segment
    link_from: jax.Array  # uint32[L]
    link_to: jax.Array  # uint32[L]

    # (segment, path)-sorted index.
    perm: jax.Array  # int32[S] step index at each sorted position
    step_path_sorted: jax.Array  # int32[S]
    seg_bounds: jax.Array  # int32[N+1]
    run_start: jax.Array  # int32[S]

    # Run-level index: one entry per (segment, path) group. Masked
    # depth queries over runs touch R <= S elements — the sort already
    # collapsed duplicate (segment, path) pairs.
    run_path: jax.Array  # int32[R]
    run_count: jax.Array  # int32[R]
    run_seg_bounds: jax.Array  # int32[N+1]

    # Link-endpoint histogram index (for degree): endpoints sorted by seg.
    link_seg_bounds: jax.Array  # int32[N+1]

    # Dense crossing matrix (kernels/crossmat.py): A[p, n] = crossings
    # of path p over segment n. Nibble-packed uint8 (two path rows per
    # byte, counts clipped at 15) or int8 (clipped at 127) — see
    # ``cross_nibble``. Clipped remainders live in the dense residual
    # sidecar: ``cross_res[p, k]`` holds count - clip for segment
    # ``cross_res_seg[k]`` (crossings are Zipf-distributed, so the
    # overflowing cells cluster in few segments; a dense dot + K-sized
    # scatter beats a per-cell COO scatter). Sidecar padding columns
    # carry segment id 2**30, dropped by the fixup scatter. Built at
    # ingest when it fits the size budget; empty (0, 0) otherwise.
    cross_matrix: jax.Array  # uint8[P_pad/2, N_pad] | int8[P_pad, N_pad]
    cross_res: jax.Array  # int32[P_pad, K_pad] or (0, 0)
    cross_res_seg: jax.Array  # int32[K_pad]

    # ELL-packed run index, tiered split layout (kernels/ellscan.py):
    # tier-1 segments (runs fit K1 slots, counts fit 16 bits) pack K1
    # slots per column, each ``path << 16 | count`` — or, when
    # ``ell_pack16`` is set (<= 256 paths, single-objective plans),
    # two 16-bit ``path << 8 | count`` halves per int32 word with
    # ``ell_k*`` recording STORED word counts; tier-2/3 segments
    # K2/K3 > K1 slots; the heaviest move whole to a nibble-packed
    # sub-crossing-matrix over just their columns (counts clipped at 15
    # with an int32 clip residual — the crossmat sidecar scheme
    # recursively applied); segments with no crossings at all are the
    # *empty* class and buy no device work. Query outputs come back in
    # the permuted order ``ell_order = [tier1, tier2, tier3, heavy,
    # empty]`` — pure concatenation plus an ingest-known zero tail, no
    # scatter and no gather; ``ell_order`` is empty for the identity
    # split. Tiers are stored flat, (K, cols) with cols padded to 128.
    cross_ell: jax.Array  # int32[K1, C1] or (0, 0) (tier 1)
    cross_ell2: jax.Array  # int32[K2, C2] or (0, 0) (tier 2)
    cross_ell3: jax.Array  # int32[K3, C3] or (0, 0) (tier 3)
    ell_order: jax.Array  # int32[N] or (0,)
    ell_heavy: jax.Array  # uint8[P_pad/2, NH_pad] or (0, 0)
    ell_heavy_res: jax.Array  # int32[P_pad, K3_pad] or (0, 0)
    ell_heavy_res_col: jax.Array  # int32[K3_pad] cols within heavy block

    num_segments: int
    num_paths: int
    cross_nibble: bool = False
    # Class sizes of the tiered split ELL layout: ``ell_order`` is
    # [tier1, tier2, tier3, heavy, empty]; ``ell_num_light`` equals
    # num_segments for the identity (untiered) split.
    ell_num_light: int = 0
    ell_num_mid: int = 0
    ell_num_mid2: int = 0
    ell_num_heavy: int = 0
    # Stored slot rows of the tiers (static); 0 = tier absent.
    ell_k: int = 0
    ell_k2: int = 0
    ell_k3: int = 0
    # 1 = tiers store 16-bit PAIRED slots (two path<<8|count halves per
    # int32 word; kernels/ellscan.py pair_ell16). ell_k* then record
    # STORED word counts, not logical slot counts.
    ell_pack16: int = 0

    @property
    def num_steps(self) -> int:
        return self.steps.shape[0]

    @property
    def num_links(self) -> int:
        return self.link_from.shape[0]


def build_device_graph(
    g: GraphArrays,
    device=None,
    minimal: bool = False,
    cross_matrix: str = "auto",
    ell_objective: str | None = None,
) -> DeviceGraph:
    """Ingest an arena: precompute the sort index and ship tensors to
    device memory (``build_host_index`` then ``upload``).

    ``device="host"`` keeps every array as host numpy — nothing touches
    a backend (bench.py runs the router on it, then ships only the
    chosen index's tensors). See ``build_host_index`` for the rest.
    """
    host = build_host_index(
        g, minimal=minimal, cross_matrix=cross_matrix,
        ell_objective=ell_objective,
    )
    return host if device == "host" else upload(host, device)


def upload(dg: DeviceGraph, device=None) -> DeviceGraph:
    """Ship every array of a host-built index to ``device`` (JAX's
    default device when None)."""
    return jax.tree_util.tree_map(partial(jax.device_put, device=device), dg)


def build_host_index(
    g: GraphArrays,
    minimal: bool = False,
    cross_matrix: str = "auto",
    ell_objective: str | None = None,
) -> DeviceGraph:
    """Build the whole index in host numpy (a DeviceGraph with numpy
    leaves).

    ``minimal=True`` keeps only the index tensors the depth queries
    read (benchmarks; skips transfers of pools the measured query never
    reads).

    ``cross_matrix``: "auto" builds the dense crossing matrix (gather-
    free masked depth, kernels/crossmat.py) when it fits the
    POLLEN_CROSS_BUDGET_MB budget (default 256); "always"/"never"
    override.

    ``ell_objective``: "single" (default) plans the tier split for
    lowest single-query latency; "batch" for lowest per-query cost in
    batched serving (finer tiers: the batched query amortizes each
    tier's fixed cost over the batch). POLLEN_ELL_OBJECTIVE sets the
    default.
    """
    n, p, s = g.num_segments, g.num_paths, g.num_steps

    step_seg = g.step_segs  # int32[S]
    step_path = g.step_path_ids()

    # Sort steps by (segment, path). np.lexsort: last key is primary.
    perm = np.lexsort((step_path, step_seg)).astype(np.int32)
    seg_sorted = step_seg[perm]
    path_sorted = step_path[perm]

    # Segment run boundaries in sorted order. (int32 probe values: a
    # wider dtype silently promotes the whole 4M+-element sorted array
    # inside searchsorted.)
    seg_bounds = np.searchsorted(
        seg_sorted, np.arange(n + 1, dtype=np.int32)
    ).astype(np.int32)

    # (segment, path) group starts + the run-level index.
    if s:
        new_run = np.empty(s, dtype=bool)
        new_run[0] = True
        new_run[1:] = (seg_sorted[1:] != seg_sorted[:-1]) | (
            path_sorted[1:] != path_sorted[:-1]
        )
        starts = np.flatnonzero(new_run).astype(np.int32)
        run_count = np.diff(
            np.concatenate([starts, [s]])
        ).astype(np.int32)
        run_start = np.repeat(starts, run_count)
        run_path = path_sorted[starts]
        run_seg_bounds = np.searchsorted(
            seg_sorted[starts], np.arange(n + 1, dtype=np.int32)
        ).astype(np.int32)
    else:
        starts = np.zeros(0, dtype=np.int32)
        run_start = np.zeros(0, dtype=np.int32)
        run_path = np.zeros(0, dtype=np.int32)
        run_count = np.zeros(0, dtype=np.int32)
        run_seg_bounds = np.zeros(n + 1, dtype=np.int32)

    # Dense crossing matrix: densify the run-level index when the
    # budget allows (see kernels/crossmat.py). Pick the cheaper of the
    # two layouts per graph: nibble packing halves the matrix bytes but
    # clips at 15, so duplicate-heavy graphs whose residual sidecar
    # would outweigh the savings stay int8.
    from .kernels.crossmat import (
        CLIP,
        CLIP_NIBBLE,
        LANES,
        RES_SENTINEL,
    )

    p_pad_m = -(-max(p, 1) // LANES) * LANES
    n_pad_m = -(-max(n, 1) // LANES) * LANES
    budget = float(os.environ.get("POLLEN_CROSS_BUDGET_MB", "256")) * 2**20
    build_cross = s > 0 and p > 0 and n > 0 and cross_matrix != "never"
    run_seg = seg_sorted[starts]

    def _sidecar_cols(clip: int):
        over = np.flatnonzero(run_count > clip)
        segs = np.unique(run_seg[over])
        k_pad = -(-segs.size // LANES) * LANES if segs.size else 0
        return over, segs, k_pad

    over_n, segs_n, k_n = _sidecar_cols(CLIP_NIBBLE)
    over_8, segs_8, k_8 = _sidecar_cols(CLIP)
    nib_bytes = (p_pad_m // 2) * n_pad_m + p_pad_m * k_n * 4
    i8_bytes = p_pad_m * n_pad_m + p_pad_m * k_8 * 4
    use_nibble = nib_bytes <= i8_bytes
    if cross_matrix == "auto" and min(nib_bytes, i8_bytes) > budget:
        build_cross = False
    if build_cross:
        clip = CLIP_NIBBLE if use_nibble else CLIP
        over, segs, k_pad = (
            (over_n, segs_n, k_n) if use_nibble else (over_8, segs_8, k_8)
        )
        counts = np.minimum(run_count, clip)
        if use_nibble:
            # Scatter straight into the packed uint8 matrix — building a
            # dense (P_pad, N_pad) int32 intermediate and strided-OR
            # packing it costs ~10x the whole rest of ingest.
            cross = np.zeros((p_pad_m // 2, n_pad_m), np.uint8)
            even = (run_path & 1) == 0
            cross[run_path[even] >> 1, run_seg[even]] = counts[
                even
            ].astype(np.uint8)
            odd = ~even
            # (path, seg) runs are unique, and distinct odd paths map to
            # distinct rows, so the fancy read-or-write never collides.
            cross[run_path[odd] >> 1, run_seg[odd]] |= (
                counts[odd].astype(np.uint8) << 4
            )
        else:
            cross = np.zeros((p_pad_m, n_pad_m), np.int8)
            cross[run_path, run_seg] = counts.astype(np.int8)
        cross_res = np.zeros((p_pad_m, k_pad), np.int32)
        cross_res_seg = np.full(k_pad, RES_SENTINEL, np.int32)
        if k_pad:
            col = np.searchsorted(segs, run_seg[over])
            cross_res[run_path[over], col] = run_count[over] - clip
            cross_res_seg[: segs.size] = segs
    else:
        use_nibble = False
        cross = np.zeros((0, 0), np.int8)
        cross_res = np.zeros((0, 0), np.int32)
        cross_res_seg = np.zeros(0, np.int32)

    # ELL-packed run index, tiered split layout (sliced-ELL style,
    # kernels/ellscan.py): tier-t segments pack K_t ELL slots per
    # column; the heaviest move whole to a nibble sub-matrix over their
    # own columns; segments no path crosses need NO device work at all
    # (their depth/uniq are zero by construction — about half the
    # segments in Zipf-crossed graphs). Outputs concatenate in
    # ``ell_order = [tier1, tier2, tier3, heavy, empty]`` — no scatter,
    # no gather. Built when paths fit the int16 packing and the arrays
    # fit the budget; ops/depth.py routes queries to it first.
    ell = np.zeros((0, 0), np.int32)
    ell2 = np.zeros((0, 0), np.int32)
    ell3 = np.zeros((0, 0), np.int32)
    ell_order = np.zeros(0, np.int32)
    ell_heavy = np.zeros((0, 0), np.uint8)
    ell_heavy_res = np.zeros((0, 0), np.int32)
    ell_heavy_res_col = np.zeros(0, np.int32)
    ell_nl = n  # tier-1 count (identity split when no ELL is built)
    ell_nm = 0  # tier-2 count
    ell_nm2 = 0  # tier-3 count
    ell_nh = 0  # heavy count
    k_ell = k_ell2 = k_ell3 = 0
    ell_pack16_v = 0
    if (
        s > 0
        and 0 < p < (1 << 16)
        and n > 0
        and cross_matrix != "never"
    ):
        from .kernels.ellscan import (
            COUNT_MAX,
            pack_ell,
            pair_ell16,
            plan_ell_tiers_n,
        )

        runs_per_seg = np.bincount(run_seg, minlength=n)
        big_seg = np.zeros(n, bool)
        big_seg[run_seg[run_count > COUNT_MAX]] = True
        if ell_objective is None:
            ell_objective = os.environ.get(
                "POLLEN_ELL_OBJECTIVE", "single"
            )
        # 16-bit paired slots for haplotype-scale path counts: two
        # path<<8|count halves per int32 word halve the resident tier
        # bytes and the bytes each single query streams. Batch-objective
        # plans keep 32-bit slots (the batched query re-reads its slots
        # once per batch, so the unpack work weighs more than the
        # bytes). Segments with any run count > 255 route whole to the
        # heavy class instead of carrying a clip residual.
        use_pack16 = (
            p <= 256
            and ell_objective != "batch"
            and os.environ.get("POLLEN_ELL_PACK16", "1") == "1"
        )
        if use_pack16:
            big_seg[run_seg[run_count > 255]] = True
        ks, tier_masks, heavy_b = plan_ell_tiers_n(
            runs_per_seg, big_seg, p_pad_m, objective=ell_objective
        )
        tier_ids = [
            np.flatnonzero(t).astype(np.int32) for t in tier_masks
        ]
        heavy_ids = np.flatnonzero(heavy_b).astype(np.int32)
        not_empty = heavy_b.copy()
        for t in tier_masks:
            not_empty |= t
        empty_ids = np.flatnonzero(~not_empty).astype(np.int32)
        tier_counts = [ids.size for ids in tier_ids]
        nh = heavy_ids.size
        nh_pad = -(-nh // LANES) * LANES
        hv = heavy_b[run_seg]
        over_h = hv & (run_count > CLIP_NIBBLE)
        over_cols = np.unique(run_seg[over_h])
        k3 = -(-over_cols.size // LANES) * LANES if over_cols.size else 0

        def col_pad(c: int) -> int:
            return -(-max(c, 1) // LANES) * LANES

        # pack16 stores ceil(k/2) int32 words per column — charge the
        # ACTUAL resident footprint or budget-constrained graphs lose
        # the index pack16 exists to shrink.
        ell_bytes = (
            sum(
                4 * ((k + 1) // 2 if use_pack16 else k) * col_pad(c)
                for k, c in zip(ks, tier_counts)
            )
            + (p_pad_m // 2) * nh_pad
            + 4 * p_pad_m * k3
        )
        # Charge the ELL index against the budget *remaining* after the
        # dense matrix: both indexes stay resident, so their combined
        # footprint must fit POLLEN_CROSS_BUDGET_MB.
        spent = cross.nbytes + cross_res.nbytes if build_cross else 0
        if ks and (
            cross_matrix == "always" or ell_bytes <= budget - spent
        ):
            # Tier slots: runs grouped by segment; slot = index in
            # group (all < the tier's K by construction of the split).
            seg_starts = np.concatenate(([0], np.cumsum(runs_per_seg)))
            slot = (
                np.arange(run_seg.size, dtype=np.int64)
                - seg_starts[run_seg]
            )

            def store_tier(t_b, k, cols):
                """Pack one tier; pack16 pairs slots (counts <= 255 and
                paths < 256 guaranteed by the big_seg routing above).
                Returns (slots_array, STORED word count)."""
                seg_to_col = np.cumsum(t_b) - 1  # local col per segment
                v = t_b[run_seg]
                e = pack_ell(
                    run_path[v],
                    run_count[v],
                    seg_to_col[run_seg[v]],
                    slot[v],
                    k,
                    col_pad(cols),
                )
                if use_pack16:
                    return pair_ell16(e), (k + 1) // 2
                return e, k

            ell, k_ell = store_tier(
                tier_masks[0], ks[0], tier_counts[0]
            )
            ell_pack16_v = 1 if use_pack16 else 0
            if len(ks) > 1:
                ell2, k_ell2 = store_tier(
                    tier_masks[1], ks[1], tier_counts[1]
                )
            if len(ks) > 2:
                ell3, k_ell3 = store_tier(
                    tier_masks[2], ks[2], tier_counts[2]
                )
            ell_nl = tier_counts[0]
            ell_nm = tier_counts[1] if len(ks) > 1 else 0
            ell_nm2 = tier_counts[2] if len(ks) > 2 else 0
            ell_nh = nh
            if ell_nm or ell_nm2 or nh or empty_ids.size:
                if nh:
                    # Heavy columns with clip overflow come FIRST in
                    # the heavy block, so the query's residual fixup is
                    # a prefix slice-add instead of a scatter.
                    if over_cols.size:
                        rest = heavy_ids[~np.isin(heavy_ids, over_cols)]
                        heavy_ids = np.concatenate(
                            [over_cols.astype(np.int32), rest]
                        )
                ell_order = np.concatenate(
                    tier_ids + [heavy_ids, empty_ids]
                )
            if nh:
                seg_to_heavy = np.zeros(n, np.int64)
                seg_to_heavy[heavy_ids] = np.arange(nh)
                h_path = run_path[hv]
                h_col = seg_to_heavy[run_seg[hv]]
                h_counts = np.minimum(run_count[hv], CLIP_NIBBLE)
                # Nibble-pack straight into the packed byte matrix
                # (same even/odd row trick as the crossing matrix).
                ell_heavy = np.zeros((p_pad_m // 2, nh_pad), np.uint8)
                even = (h_path & 1) == 0
                ell_heavy[h_path[even] >> 1, h_col[even]] = h_counts[
                    even
                ].astype(np.uint8)
                odd = ~even
                ell_heavy[h_path[odd] >> 1, h_col[odd]] |= (
                    h_counts[odd].astype(np.uint8) << 4
                )
                if k3:
                    ell_heavy_res = np.zeros((p_pad_m, k3), np.int32)
                    ell_heavy_res_col = np.full(k3, RES_SENTINEL, np.int32)
                    colr = np.searchsorted(over_cols, run_seg[over_h])
                    ell_heavy_res[
                        run_path[over_h],
                        colr,
                    ] = run_count[over_h] - CLIP_NIBBLE
                    ell_heavy_res_col[: over_cols.size] = seg_to_heavy[
                        over_cols
                    ]

    # Path step-span boundaries (step spans are contiguous in path order).
    path_bounds = np.concatenate(
        ([0], np.cumsum(g.path_steps[:, 1] - g.path_steps[:, 0]))
    ).astype(np.int32)

    # Degree index: both link endpoints, histogrammed by segment.
    endpoints = np.concatenate(
        [(g.link_from >> 1).astype(np.int32), (g.link_to >> 1).astype(np.int32)]
    )
    endpoints.sort()
    link_seg_bounds = np.searchsorted(
        endpoints, np.arange(n + 1, dtype=np.int32)
    ).astype(np.int32)

    def full(x, dtype):
        return np.asarray(x, dtype) if not minimal else np.zeros(0, dtype)

    return DeviceGraph(
        steps=full(g.steps, np.uint32),
        step_path=full(step_path, np.int32),
        path_bounds=path_bounds,
        seg_len=full(g.seg_len, np.int32),
        link_from=np.asarray(g.link_from, np.uint32),
        link_to=np.asarray(g.link_to, np.uint32),
        perm=full(perm, np.int32),
        step_path_sorted=path_sorted.astype(np.int32),
        seg_bounds=seg_bounds,
        run_start=run_start.astype(np.int32),
        run_path=run_path.astype(np.int32),
        run_count=run_count.astype(np.int32),
        run_seg_bounds=run_seg_bounds,
        link_seg_bounds=link_seg_bounds,
        cross_matrix=cross,
        cross_res=cross_res,
        cross_res_seg=cross_res_seg,
        cross_ell=ell,
        cross_ell2=ell2,
        cross_ell3=ell3,
        ell_order=ell_order.astype(np.int32),
        ell_heavy=ell_heavy,
        ell_heavy_res=ell_heavy_res,
        ell_heavy_res_col=ell_heavy_res_col,
        num_segments=n,
        num_paths=p,
        cross_nibble=use_nibble,
        ell_num_light=ell_nl,
        ell_num_mid=ell_nm,
        ell_num_mid2=ell_nm2,
        ell_num_heavy=ell_nh,
        ell_k=k_ell,
        ell_k2=k_ell2,
        ell_k3=k_ell3,
        ell_pack16=ell_pack16_v,
    )


# ---------------------------------------------------------------------------
# Core segmented reductions (all dense; no scatter)
# ---------------------------------------------------------------------------


def boundary_values(csum: jax.Array, bounds: jax.Array) -> jax.Array:
    """``exclusive_csum[bounds]`` — the gather at the heart of every
    boundary-difference reduction (callers gather once and diff)."""
    padded = jnp.concatenate([jnp.zeros((1,), csum.dtype), csum])
    return padded[bounds]


def boundary_diff(csum: jax.Array, bounds: jax.Array) -> jax.Array:
    """Per-range sums of the sequence whose inclusive cumsum is
    ``csum``, for contiguous ranges [bounds[i], bounds[i+1])."""
    v = boundary_values(csum, bounds)
    return v[1:] - v[:-1]


def bounded_segment_sum(
    weights: jax.Array, bounds: jax.Array
) -> jax.Array:
    """Sum ``weights`` within each [bounds[i], bounds[i+1]) range.

    ``weights`` must already be ordered so ranges are contiguous. One
    cumsum + one boundary gather: bandwidth-bound, scatter-free.
    """
    return boundary_diff(jnp.cumsum(weights), bounds)


def first_in_group_mask(
    weights: jax.Array, run_start: jax.Array
) -> jax.Array:
    """1 where a nonzero weight is the first nonzero in its group.

    Groups are contiguous runs whose start positions are ``run_start``.
    Used for distinct-count reductions (depth.uniq): counting first
    occurrences per (segment, path) group counts distinct paths.
    """
    w = (weights != 0).astype(jnp.int32)
    csum = jnp.cumsum(w)
    excl = csum - w  # exclusive cumsum
    within = csum - excl[run_start]  # inclusive count within the group
    return w * (within == 1).astype(jnp.int32)
