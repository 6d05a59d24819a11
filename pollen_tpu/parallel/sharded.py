"""Sharded depth/degree: the step list split across a device mesh.

Design (per BASELINE.json's north star): the (segment, path)-sorted step
index is sharded into contiguous chunks over every device in a
``Mesh(hosts, chips)``; segment-indexed tables (N-sized boundaries) are
replicated; each device computes a partial histogram over its chunk with
the same scatter-free cumsum trick as the single-device path; partials
merge with ``psum``.

The subtle part is ``depth.uniq`` (distinct paths per segment): a
(segment, path) group can straddle chunk boundaries, so "first masked
step of the group" needs cross-chunk information. We use a decoupled
lookback: every group is identified by its *global start position*; each
device all-gathers one (tail-group id, tail-group masked count) pair and
adds the carry from devices to its left before testing "am I first".
One tiny all-gather + one psum per query — no scatter, no host sync.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..device import DeviceGraph

STEP_AXES = ("host", "chip")  # step chunks are sharded over both axes


def make_mesh(
    devices=None, hosts: Optional[int] = None
) -> Mesh:
    """A (host, chip) mesh over the given (or all) devices: one row per
    process (``jax.process_count()``) unless ``hosts`` says otherwise."""
    devices = list(jax.devices()) if devices is None else list(devices)
    n = len(devices)
    if hosts is None:
        hosts = jax.process_count()
    if n % hosts:
        raise ValueError(f"{n} devices do not split into {hosts} host rows")
    arr = np.array(devices).reshape(hosts, n // hosts)
    return Mesh(arr, STEP_AXES)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=[
        "step_path_sorted",
        "run_start",
        "seg_bounds",
        "chunk_starts",
    ],
    meta_fields=["num_segments", "num_paths", "num_steps", "chunk"],
)
@dataclasses.dataclass
class ShardedGraph:
    """Step-sharded view of a graph for mesh execution.

    ``step_path_sorted`` and ``run_start`` are padded to a multiple of
    the device count and sharded by contiguous chunk; ``seg_bounds`` is
    replicated. Padding uses a sentinel path id (= num_paths) whose mask
    entry is always 0.
    """

    step_path_sorted: jax.Array  # int32[S_pad] sharded
    run_start: jax.Array  # int32[S_pad] sharded (global positions)
    seg_bounds: jax.Array  # int32[N+1] replicated
    chunk_starts: jax.Array  # int32[D] replicated: global start of chunk d

    num_segments: int
    num_paths: int
    num_steps: int
    chunk: int


def shard_device_graph(dg: DeviceGraph, mesh: Mesh) -> ShardedGraph:
    """Lay a DeviceGraph's sorted index out across a mesh."""
    n_dev = mesh.size
    path_sorted = np.asarray(dg.step_path_sorted)
    run_start = np.asarray(dg.run_start)
    s = path_sorted.shape[0]
    chunk = -(-max(s, 1) // n_dev)
    s_pad = chunk * n_dev
    pad = s_pad - s
    # Sentinel padding: fake path (mask 0), each pad step its own group.
    path_sorted = np.concatenate(
        [path_sorted, np.full(pad, dg.num_paths, np.int32)]
    )
    run_start = np.concatenate(
        [run_start, np.arange(s, s_pad, dtype=np.int32)]
    )

    step_sharding = NamedSharding(mesh, P(STEP_AXES))
    repl = NamedSharding(mesh, P())
    chunk = s_pad // n_dev
    return ShardedGraph(
        step_path_sorted=jax.device_put(jnp.asarray(path_sorted), step_sharding),
        run_start=jax.device_put(jnp.asarray(run_start), step_sharding),
        seg_bounds=jax.device_put(dg.seg_bounds, repl),
        chunk_starts=jax.device_put(
            jnp.arange(n_dev, dtype=jnp.int32) * chunk, repl
        ),
        num_segments=dg.num_segments,
        num_paths=dg.num_paths,
        num_steps=s,
        chunk=chunk,
    )


def _local_depth_uniq(
    path_chunk: jax.Array,  # int32[C] local sorted step -> path
    run_start: jax.Array,  # int32[C] global group starts
    seg_bounds: jax.Array,  # int32[N+1] global
    chunk_start: jax.Array,  # int32[] global offset of this chunk
    mask_ext: jax.Array,  # int32[P+1] path mask with sentinel 0
    axis_names: Tuple[str, ...],
) -> Tuple[jax.Array, jax.Array]:
    """Per-device partial (depth, uniq) histograms; caller psums."""
    c_size = path_chunk.shape[0]
    w = mask_ext[path_chunk]

    csum = jnp.cumsum(w)
    padded = jnp.concatenate([jnp.zeros((1,), csum.dtype), csum])

    # Partial plain depth: clip each segment's global range to the chunk.
    lo = jnp.clip(seg_bounds[:-1] - chunk_start, 0, c_size)
    hi = jnp.clip(seg_bounds[1:] - chunk_start, 0, c_size)
    depth_partial = padded[hi] - padded[lo]

    # Uniq: masked count within each group, with cross-chunk carry.
    local_start = jnp.clip(run_start - chunk_start, 0, c_size - 1)
    excl = csum - w
    within_local = csum - excl[local_start]

    # Tail-group summary for the lookback: the last group's global id
    # and how many masked steps of it live in this chunk.
    tail_key = run_start[-1]
    tail_count = csum[-1] - excl[local_start[-1]]

    keys = jax.lax.all_gather(tail_key, axis_names, tiled=False)
    counts = jax.lax.all_gather(tail_count, axis_names, tiled=False)
    keys = keys.reshape(-1)
    counts = counts.reshape(-1)

    my_index = chunk_start // c_size
    head_key = run_start[0]
    from_left = jnp.arange(keys.shape[0]) < my_index
    carry = jnp.sum(jnp.where(from_left & (keys == head_key), counts, 0))

    # Only positions whose group began before this chunk get the carry.
    started_before = run_start < chunk_start
    within = within_local + jnp.where(started_before, carry, 0)
    first = w * (within == 1).astype(w.dtype)

    fsum = jnp.cumsum(first)
    fpadded = jnp.concatenate([jnp.zeros((1,), fsum.dtype), fsum])
    uniq_partial = fpadded[hi] - fpadded[lo]
    return depth_partial, uniq_partial


def sharded_seg_depth_fn(
    mesh: Mesh,
) -> Callable[[ShardedGraph, jax.Array], Tuple[jax.Array, jax.Array]]:
    """Build the jitted mesh-wide (depth, uniq) query.

    The returned function takes a ShardedGraph and a bool/int mask of
    shape [P+1] (last entry 0: the padding sentinel) and returns
    replicated int32[N] depth and uniq vectors.
    """

    @jax.jit
    def query(sg: ShardedGraph, mask_ext: jax.Array):
        def worker(path_chunk, run_start, seg_bounds, chunk_starts, mask):
            idx = jax.lax.axis_index(STEP_AXES)
            chunk_start = chunk_starts[idx]
            d, u = _local_depth_uniq(
                path_chunk,
                run_start,
                seg_bounds,
                chunk_start,
                mask,
                STEP_AXES,
            )
            return (
                jax.lax.psum(d, STEP_AXES),
                jax.lax.psum(u, STEP_AXES),
            )

        return jax.shard_map(
            worker,
            mesh=mesh,
            in_specs=(P(STEP_AXES), P(STEP_AXES), P(), P(), P()),
            out_specs=(P(), P()),
        )(
            sg.step_path_sorted,
            sg.run_start,
            sg.seg_bounds,
            sg.chunk_starts,
            mask_ext,
        )

    return query


def sharded_seg_depth_scatter_fn(mesh: Mesh):
    """Mesh-wide (depth, uniq) with the *output* sharded too.

    Like :func:`sharded_seg_depth_fn`, but partials merge with
    ``psum_scatter`` over the chip axis: each device keeps only its
    slice of the N-sized result (the tensor-parallel analogue for
    segment-indexed outputs — for graphs whose segment tables are too
    large to replicate). Requires (N + 1) padded to a multiple of the
    chip-axis size times 1; callers slice the valid prefix.
    """

    @jax.jit
    def query(sg: ShardedGraph, mask_ext: jax.Array):
        def worker(path_chunk, run_start, seg_bounds, chunk_starts, mask):
            idx = jax.lax.axis_index(STEP_AXES)
            chunk_start = chunk_starts[idx]
            d, u = _local_depth_uniq(
                path_chunk,
                run_start,
                seg_bounds,
                chunk_start,
                mask,
                STEP_AXES,
            )
            # Sum over hosts (replicated result per host row), then
            # scatter the segment axis across chips.
            d = jax.lax.psum(d, "host")
            u = jax.lax.psum(u, "host")
            chips = jax.lax.axis_size("chip")
            pad = (-d.shape[0]) % chips
            d = jnp.concatenate([d, jnp.zeros(pad, d.dtype)])
            u = jnp.concatenate([u, jnp.zeros(pad, u.dtype)])
            d = jax.lax.psum_scatter(d, "chip", scatter_dimension=0, tiled=True)
            u = jax.lax.psum_scatter(u, "chip", scatter_dimension=0, tiled=True)
            return d, u

        return jax.shard_map(
            worker,
            mesh=mesh,
            in_specs=(P(STEP_AXES), P(STEP_AXES), P(), P(), P()),
            out_specs=(P("chip"), P("chip")),
        )(
            sg.step_path_sorted,
            sg.run_start,
            sg.seg_bounds,
            sg.chunk_starts,
            mask_ext,
        )

    return query


def sharded_degree_fn(mesh: Mesh):
    """Mesh-wide degree: link-endpoint chunks sharded, boundary table
    replicated, partial histograms merged with psum."""

    @jax.jit
    def query(weights: jax.Array, chunk_starts: jax.Array, bounds: jax.Array):
        def worker(w, chunk_starts, bounds):
            idx = jax.lax.axis_index(STEP_AXES)
            chunk_start = chunk_starts[idx]
            c_size = w.shape[0]
            csum = jnp.cumsum(w)
            padded = jnp.concatenate([jnp.zeros((1,), csum.dtype), csum])
            lo = jnp.clip(bounds[:-1] - chunk_start, 0, c_size)
            hi = jnp.clip(bounds[1:] - chunk_start, 0, c_size)
            return jax.lax.psum(padded[hi] - padded[lo], STEP_AXES)

        return jax.shard_map(
            worker,
            mesh=mesh,
            in_specs=(P(STEP_AXES), P(), P()),
            out_specs=P(),
        )(weights, chunk_starts, bounds)

    return query


def shard_degree_inputs(dg: DeviceGraph, mesh: Mesh):
    """(sharded endpoint weights, chunk starts, replicated bounds)."""
    n_dev = mesh.size
    total = int(dg.link_seg_bounds[-1])
    pad = -(-max(total, 1) // n_dev) * n_dev - total
    weights = np.concatenate(
        [np.ones(total, np.int32), np.zeros(pad, np.int32)]
    )
    chunk = weights.shape[0] // n_dev
    step_sharding = NamedSharding(mesh, P(STEP_AXES))
    repl = NamedSharding(mesh, P())
    return (
        jax.device_put(jnp.asarray(weights), step_sharding),
        jax.device_put(
            jnp.arange(n_dev, dtype=jnp.int32) * chunk, repl
        ),
        jax.device_put(dg.link_seg_bounds, repl),
    )


# ---------------------------------------------------------------------------
# Sharded crossing-matrix depth (tensor-parallel over the segment axis)
# ---------------------------------------------------------------------------


class ShardedCross(NamedTuple):
    """Crossing matrix laid out over a mesh: packed columns (segments)
    sharded across every device, residual sidecar replicated."""

    cross: jax.Array  # packed rows x (col_width * n_dev), column-sharded
    res: jax.Array  # int32[P_pad, K_pad], replicated
    res_seg: jax.Array  # int32[K_pad], replicated (sentinel-padded)
    col_width: int  # segment columns per device
    num_paths_padded: int  # mask length the query expects
    nibble: bool  # two path rows per matrix byte?


def shard_cross_inputs(dg: DeviceGraph, mesh: Mesh):
    """Lay the crossing matrix out over the mesh (see ShardedCross);
    returns None when the graph has no crossing matrix. Column counts
    are padded so every device gets an equal, 128-aligned slice."""
    if dg.cross_matrix.size == 0:
        return None
    a = np.asarray(dg.cross_matrix)
    n_dev = mesh.size
    rows, n_pad = a.shape
    p_pad = rows * 2 if dg.cross_nibble else rows
    width = -(-n_pad // (n_dev * 128)) * 128
    total = width * n_dev
    if total > n_pad:
        a = np.concatenate(
            [a, np.zeros((rows, total - n_pad), a.dtype)], axis=1
        )
    col_shard = NamedSharding(mesh, P(None, STEP_AXES))
    repl = NamedSharding(mesh, P())
    return ShardedCross(
        cross=jax.device_put(jnp.asarray(a), col_shard),
        res=jax.device_put(dg.cross_res, repl),
        res_seg=jax.device_put(dg.cross_res_seg, repl),
        col_width=width,
        num_paths_padded=p_pad,
        nibble=dg.cross_nibble,
    )


def sharded_cross_depth_fn(mesh: Mesh, nibble: bool = False):
    """Mesh-wide masked (depth, uniq) over the sharded crossing matrix.

    Tensor parallelism in its purest form: each device computes the
    masked column sum for its own segment columns; outputs stay
    segment-sharded and NO collective runs at all (the mask is
    replicated, the residual fixup is range-filtered locally with
    dropped out-of-range scatters).
    """
    from ..kernels.crossmat import masked_cross_depth_xla

    @jax.jit
    def query(cross, res, res_seg, mask):
        def worker(a, res, res_seg, mask):
            idx = jax.lax.axis_index(STEP_AXES)
            width = a.shape[1]
            depth, uniq = masked_cross_depth_xla(a, mask, nibble=nibble)
            # Residual remainders for my column range only. mode="drop"
            # only drops indices PAST the end — negative shifted
            # indices wrap around (numpy semantics) and would land
            # other devices' residuals in my first columns — so remap
            # every out-of-range index to `width` (one past the end).
            if res_seg.shape[0]:
                fix = jnp.sum(res * mask[:, None], axis=0, dtype=jnp.int32)
                local = res_seg - idx * width
                local = jnp.where(
                    (local >= 0) & (local < width), local, width
                )
                depth = depth.at[local].add(fix, mode="drop")
            return depth, uniq

        return jax.shard_map(
            worker,
            mesh=mesh,
            in_specs=(P(None, STEP_AXES), P(), P(), P()),
            out_specs=(P(STEP_AXES), P(STEP_AXES)),
        )(cross, res, res_seg, mask)

    return query


class ShardedEll(NamedTuple):
    """Tiered split ELL run index laid out over a mesh: tier-1 and
    tier-2 slot columns AND heavy nibble columns each sharded across
    every device; the tiny clip residual replicated. Query outputs
    come back as segment-sharded part vectors in the index's permuted
    order (``dg.ell_order`` = [tier1, tier2, heavy, empty]; the empty
    class needs no device part at all)."""

    ell: jax.Array  # int32[K1, light_width * n_dev], column-sharded
    ell2: jax.Array | None  # int32[K2, mid_width * n_dev] or None
    ell3: jax.Array | None  # int32[K3, mid2_width * n_dev] or None
    heavy: jax.Array | None  # uint8[P_pad/2, heavy_width * n_dev] or None
    heavy_res: jax.Array  # int32[P_pad, K3_pad], replicated
    heavy_res_col: jax.Array  # int32[K3_pad], replicated (sentinel-padded)
    light_width: int  # tier-1 columns per device
    mid_width: int  # tier-2 columns per device
    mid2_width: int  # tier-3 columns per device
    heavy_width: int  # heavy columns per device
    num_paths: int
    nibble_rows: int  # ell_heavy row count (P_pad / 2)


def _pad_cols(a: np.ndarray, n_dev: int) -> Tuple[np.ndarray, int]:
    """Pad a 2-D array's columns so every device gets an equal,
    128-aligned slice; returns (padded, width-per-device)."""
    rows, n_pad = a.shape
    width = -(-n_pad // (n_dev * 128)) * 128
    total = width * n_dev
    if total > n_pad:
        a = np.concatenate(
            [a, np.zeros((rows, total - n_pad), a.dtype)], axis=1
        )
    return a, width


def shard_ell_inputs(dg: DeviceGraph, mesh: Mesh):
    """Lay the split ELL run index out over the mesh (see ShardedEll);
    returns None when the graph has no ELL index."""
    if dg.cross_ell.size == 0:
        return None
    from ..kernels.ellscan import unpair_ell16

    n_dev = mesh.size

    def _flat(tier, k):
        # Un-pair pack16 storage back to standard slots, so the sharded
        # workers stay layout-agnostic.
        f = np.asarray(tier)
        return unpair_ell16(f) if dg.ell_pack16 else f

    flat = _flat(dg.cross_ell, dg.ell_k)
    e, lw = _pad_cols(np.ascontiguousarray(flat), n_dev)
    col_shard = NamedSharding(mesh, P(None, STEP_AXES))
    repl = NamedSharding(mesh, P())
    ell2 = None
    mw = 0
    if dg.cross_ell2.size:
        flat2 = _flat(dg.cross_ell2, dg.ell_k2)
        e2, mw = _pad_cols(np.ascontiguousarray(flat2), n_dev)
        ell2 = jax.device_put(jnp.asarray(e2), col_shard)
    ell3 = None
    m2w = 0
    if dg.cross_ell3.size:
        flat3 = _flat(dg.cross_ell3, dg.ell_k3)
        e3, m2w = _pad_cols(np.ascontiguousarray(flat3), n_dev)
        ell3 = jax.device_put(jnp.asarray(e3), col_shard)
    heavy = None
    hw = 0
    rows = 0
    if dg.ell_heavy.size:
        h, hw = _pad_cols(np.asarray(dg.ell_heavy), n_dev)
        heavy = jax.device_put(jnp.asarray(h), col_shard)
        rows = h.shape[0]
    return ShardedEll(
        ell=jax.device_put(jnp.asarray(e), col_shard),
        ell2=ell2,
        ell3=ell3,
        heavy=heavy,
        heavy_res=jax.device_put(dg.ell_heavy_res, repl),
        heavy_res_col=jax.device_put(dg.ell_heavy_res_col, repl),
        light_width=lw,
        mid_width=mw,
        mid2_width=m2w,
        heavy_width=hw,
        num_paths=dg.num_paths,
        nibble_rows=rows,
    )


def sharded_ell_depth_fn(
    mesh: Mesh,
    has_heavy: bool = False,
    has_mid: bool = False,
    has_mid2: bool = False,
):
    """Mesh-wide masked (depth, uniq) over the tiered split ELL run
    index — the same zero-collective tensor parallelism as the sharded
    crossing matrix: every device reduces its own tier-1 (and tier-2)
    slot columns and (when present) its own heavy nibble columns; the
    replicated clip residual is range-filtered locally. Outputs stay
    segment-sharded, one (depth, uniq) pair per present class in
    ``ell_order`` order: (d1, u1[, d2, u2][, dh, uh])."""
    from ..kernels.crossmat import masked_cross_depth_xla
    from ..kernels.ellscan import masked_ell_depth_xla as _tier

    @jax.jit
    def query(*args):
        def worker(*wargs):
            mask = wargs[-1]
            i = 0
            outs = list(_tier(wargs[i], mask))
            i += 1
            if has_mid:
                outs += list(_tier(wargs[i], mask))
                i += 1
            if has_mid2:
                outs += list(_tier(wargs[i], mask))
                i += 1
            if has_heavy:
                h, res, res_col = wargs[i : i + 3]
                idx = jax.lax.axis_index(STEP_AXES)
                p_pad = h.shape[0] * 2
                mp = jnp.zeros(p_pad, jnp.int32).at[
                    : mask.shape[0]
                ].set(mask.astype(jnp.int32))
                depth_h, uniq_h = masked_cross_depth_xla(
                    h, mp, nibble=True
                )
                if res_col.shape[0]:
                    fix = jnp.sum(
                        res * mp[:, None], axis=0, dtype=jnp.int32
                    )
                    # Remap out-of-range (incl. negative — they would
                    # WRAP, not drop) indices past the end.
                    w_h = h.shape[1]
                    local = res_col - idx * w_h
                    local = jnp.where(
                        (local >= 0) & (local < w_h), local, w_h
                    )
                    depth_h = depth_h.at[local].add(fix, mode="drop")
                outs += [depth_h, uniq_h]
            return tuple(outs)

        shard = P(None, STEP_AXES)
        in_specs = (
            [shard]
            + ([shard] if has_mid else [])
            + ([shard] if has_mid2 else [])
            + ([shard, P(), P()] if has_heavy else [])
            + [P()]
        )
        n_out = 2 + 2 * has_mid + 2 * has_mid2 + 2 * has_heavy
        return jax.shard_map(
            worker,
            mesh=mesh,
            in_specs=tuple(in_specs),
            out_specs=tuple([P(STEP_AXES)] * n_out),
        )(*args)

    return query


def sharded_ell_depth_batch_fn(
    mesh: Mesh,
    has_heavy: bool = False,
    has_mid: bool = False,
    has_mid2: bool = False,
):
    """Mesh-wide BATCHED masked (depth, uniq) over the tiered split
    ELL index: ``masks`` is int[Q, P] (replicated); every device
    reduces its own tier slot columns for all Q queries at once and
    (when present) turns the heavy nibble columns into one
    (Q, P) x (P, local_NH) matmul — still zero collectives, outputs
    segment-sharded per class with a leading Q axis. The multi-device
    form of batch serving (single device:
    ops/depth.seg_depth_with_uniq_ell_batch_parts)."""
    from ..kernels.crossmat import batched_cross_depth
    from ..kernels.ellscan import masked_ell_depth_xla

    _tier_b = jax.vmap(masked_ell_depth_xla, in_axes=(None, 0))

    @jax.jit
    def query(*args):
        def worker(*wargs):
            masks = wargs[-1]
            q = masks.shape[0]
            i = 0
            outs = list(_tier_b(wargs[i], masks))
            i += 1
            if has_mid:
                outs += list(_tier_b(wargs[i], masks))
                i += 1
            if has_mid2:
                outs += list(_tier_b(wargs[i], masks))
                i += 1
            if has_heavy:
                h, res, res_col = wargs[i : i + 3]
                idx = jax.lax.axis_index(STEP_AXES)
                p_pad = h.shape[0] * 2
                mp = (
                    jnp.zeros((q, p_pad), jnp.int32)
                    .at[:, : masks.shape[1]]
                    .set(masks.astype(jnp.int32))
                )
                depth_h, uniq_h = batched_cross_depth(h, mp, nibble=True)
                if res_col.shape[0]:
                    fix = jnp.einsum(
                        "qp,pk->qk",
                        mp,
                        res,
                        preferred_element_type=jnp.int32,
                    )
                    w_h = h.shape[1]
                    local = res_col - idx * w_h
                    local = jnp.where(
                        (local >= 0) & (local < w_h), local, w_h
                    )
                    depth_h = depth_h.at[:, local].add(fix, mode="drop")
                outs += [depth_h, uniq_h]
            return tuple(outs)

        shard = P(None, STEP_AXES)
        in_specs = (
            [shard]
            + ([shard] if has_mid else [])
            + ([shard] if has_mid2 else [])
            + ([shard, P(), P()] if has_heavy else [])
            + [P()]
        )
        n_out = 2 + 2 * has_mid + 2 * has_mid2 + 2 * has_heavy
        return jax.shard_map(
            worker,
            mesh=mesh,
            in_specs=tuple(in_specs),
            out_specs=tuple([P(None, STEP_AXES)] * n_out),
        )(*args)

    return query


def compose_ell_parts_natural(
    dg: DeviceGraph,
    parts,
    has_mid: bool,
    has_heavy: bool,
    has_mid2: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Reassemble a sharded tiered-ELL query's per-class part vectors
    into natural segment order on the host (ops/depth's composition,
    after folding tier 3 into the mid pair). ``parts`` is the flat
    (d, u) interleaving the sharded query returns:
    (d1, u1[, d2, u2][, d3, u3][, dh, uh])."""
    from ..ops.depth import _compose_natural

    pairs = [
        (np.asarray(parts[i]), np.asarray(parts[i + 1]))
        for i in range(0, len(parts), 2)
    ]
    (d1, u1), rest = pairs[0], pairs[1:]
    sizes = [dg.ell_num_mid] * has_mid + [dg.ell_num_mid2] * has_mid2
    mids, rest = rest[: len(sizes)], rest[len(sizes) :]
    d2 = u2 = dh = uh = None
    if mids:
        d2 = np.concatenate([d[:c] for (d, _), c in zip(mids, sizes)])
        u2 = np.concatenate([u[:c] for (_, u), c in zip(mids, sizes)])
    if has_heavy:
        dh, uh = rest[0]
    return _compose_natural(dg, (d1, u1, d2, u2, dh, uh))


def full_mask(num_paths: int) -> jax.Array:
    """An all-paths mask (with the padding sentinel zeroed)."""
    return jnp.concatenate(
        [
            jnp.ones(num_paths, dtype=jnp.int32),
            jnp.zeros(1, dtype=jnp.int32),
        ]
    )
