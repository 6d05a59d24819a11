"""Depth queries: per-segment crossing counts and per-path mean depth.

The flagship analysis (reference semantics: flatgfa/src/ops/depth.rs,
slow_odgi/depth.py). Device side, depth is a masked segment-sum over the
(segment, path)-sorted step index; depth.uniq counts first-occurrences
per (segment, path) group — both scatter-free (see pollen_tpu.device).
Subset (masked) queries run on the first resident index of: the tiered
ELL run index, the dense crossing matrix, the run-level index, the
step list (``_best_masked_impl``).
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..device import (
    DeviceGraph,
    bounded_segment_sum,
    first_in_group_mask,
)
from ..flatgfa import GraphArrays
from ..kernels import ellscan as _ellscan
from ..kernels.crossmat import batched_cross_depth, masked_cross_depth_xla


@jax.jit
def seg_depth_with_uniq(dg: DeviceGraph) -> Tuple[jax.Array, jax.Array]:
    """(depth, unique depth) per segment, over all paths.

    The all-paths answer is already encoded in the ingest index:
    depth is each segment's run length in sorted order, and uniq is its
    number of (segment, path) groups. Both are boundary differences —
    no per-step work at query time. (An all-ones cumsum here would also
    trip XLA's constant folder into a multi-second compile.)
    """
    depth = dg.seg_bounds[1:] - dg.seg_bounds[:-1]
    uniq = dg.run_seg_bounds[1:] - dg.run_seg_bounds[:-1]
    return depth, uniq


def _extend_mask(path_mask: jax.Array) -> jax.Array:
    """Append the padding sentinel's 0 entry to a bool/int mask."""
    return jnp.concatenate(
        [path_mask.astype(jnp.int32), jnp.zeros(1, jnp.int32)]
    )


@jax.jit
def seg_depth_with_uniq_masked(
    dg: DeviceGraph, path_mask: jax.Array
) -> Tuple[jax.Array, jax.Array]:
    """(depth, unique depth) per segment, counting only paths where
    ``path_mask`` (bool[P]) is set: the step-level pipeline (mask
    gather, two cumsums, boundary gathers) over the sorted step list."""
    w = _extend_mask(path_mask)[dg.step_path_sorted]
    depth = bounded_segment_sum(w, dg.seg_bounds)
    first = first_in_group_mask(w, dg.run_start)
    uniq = bounded_segment_sum(first, dg.seg_bounds)
    return depth, uniq


@jax.jit
def seg_depth_with_uniq_runs(
    dg: DeviceGraph, path_mask: jax.Array
) -> Tuple[jax.Array, jax.Array]:
    """Masked (depth, uniq) over the run-level index: O(R) work where R
    is the number of distinct (segment, path) pairs — the ingest sort
    already collapsed duplicates, so uniq needs no first-occurrence
    logic at all."""
    w = _extend_mask(path_mask)[dg.run_path]
    depth = bounded_segment_sum(w * dg.run_count, dg.run_seg_bounds)
    uniq = bounded_segment_sum(w, dg.run_seg_bounds)
    return depth, uniq


@jax.jit
def seg_depth_with_uniq_cross(
    dg: DeviceGraph, path_mask: jax.Array
) -> Tuple[jax.Array, jax.Array]:
    """Masked (depth, uniq) via the dense crossing matrix: one masked
    column sum with no gathers and no boundary stage
    (kernels/crossmat.py). The dense residual sidecar (one tiny fused
    reduce + K-sized scatter) restores counts clipped by the packed
    store."""
    p_pad = dg.cross_matrix.shape[0] * (2 if dg.cross_nibble else 1)
    m = (
        jnp.zeros(p_pad, jnp.int32)
        .at[: dg.num_paths]
        .set(path_mask.astype(jnp.int32)[: dg.num_paths])
    )
    depth, uniq = masked_cross_depth_xla(
        dg.cross_matrix, m, nibble=dg.cross_nibble
    )
    if dg.cross_res_seg.size:
        # Exact int32, fused multiply-reduce over the sidecar columns;
        # sentinel columns carry an out-of-range id and drop.
        fix = jnp.sum(dg.cross_res * m[:, None], axis=0, dtype=jnp.int32)
        depth = depth.at[dg.cross_res_seg].add(fix, mode="drop")
    return depth[: dg.num_segments], uniq[: dg.num_segments]


def _ell_tiers(dg: DeviceGraph):
    """The present tiers of the split ELL index, in ell_order order."""
    return [t for t in (dg.cross_ell, dg.cross_ell2, dg.cross_ell3) if t.size]


def _fold_mid(dg: DeviceGraph, tier_outs):
    """Flatten per-tier (d, u) pairs into ``(d1, u1, d2, u2)``: tier 3,
    when present, folds into the mid pair at exact lengths (tier-2
    columns first, as in ell_order). Works on (..., cols) arrays."""
    (d1, u1), rest = tier_outs[0], tier_outs[1:]
    if not rest:
        return d1, u1, None, None
    if len(rest) == 1:
        return (d1, u1) + rest[0]
    (d2, u2), (d3, u3) = rest
    nm, nm2 = dg.ell_num_mid, dg.ell_num_mid2
    return (
        d1,
        u1,
        jnp.concatenate([d2[..., :nm], d3[..., :nm2]], axis=-1),
        jnp.concatenate([u2[..., :nm], u3[..., :nm2]], axis=-1),
    )


@jax.jit
def seg_depth_with_uniq_ell_parts(dg: DeviceGraph, path_mask: jax.Array):
    """Masked (depth, uniq) via the tiered split ELL run index, as the
    raw per-class part vectors — the form production serving consumes
    (the sharded query returns the same parts, and host rendering
    composes them anyway, so the device never pays the concatenate).

    Tier columns: short int32 reductions over the K slots of each
    column (kernels/ellscan.py). Heavy columns: one masked column sum
    over their nibble-packed sub-matrix plus the tiny int32 clip
    residual.
    The empty class (segments no path crosses) contributes identical
    zeros known at ingest — no part at all.

    Returns ``(d1, u1, d2, u2, dh, uh)``; the tier-2 and heavy pairs
    are None when the class is absent. When a third tier exists
    (``dg.ell_k3``), its part is folded into the mid pair — ``d2``/
    ``u2`` then hold exactly ``ell_num_mid + ell_num_mid2`` entries in
    ``ell_order`` order (tier-2 columns first)."""
    m = path_mask.astype(jnp.int32)[: dg.num_paths]
    pack16 = bool(dg.ell_pack16)
    d1, u1, d2, u2 = _fold_mid(
        dg,
        [_ellscan.tier_depth(t, m, pack16=pack16) for t in _ell_tiers(dg)],
    )
    dh = uh = None
    if dg.ell_heavy.size:
        mp = jnp.zeros(
            dg.ell_heavy.shape[0] * 2, jnp.int32
        ).at[: dg.num_paths].set(m)
        dh, uh = masked_cross_depth_xla(dg.ell_heavy, mp, nibble=True)
        if dg.ell_heavy_res_col.size:
            fix = jnp.sum(
                dg.ell_heavy_res * mp[:, None], axis=0, dtype=jnp.int32
            )
            # Overflow columns occupy the heavy block's PREFIX by
            # ingest construction (device.py), so the fixup is a
            # slice-add, not a scatter; sentinel-padded residual
            # columns contribute zero.
            dh = dh.at[: dg.ell_heavy_res.shape[1]].add(fix)
    return d1, u1, d2, u2, dh, uh


def _ell_class_sizes(dg: DeviceGraph):
    """(tier-1, mid (tiers 2+3), heavy, empty) column counts."""
    nl, nh = dg.ell_num_light, dg.ell_num_heavy
    nm = dg.ell_num_mid + dg.ell_num_mid2
    return nl, nm, nh, dg.num_segments - nl - nm - nh


@jax.jit
def seg_depth_with_uniq_ell_permuted(
    dg: DeviceGraph, path_mask: jax.Array
) -> Tuple[jax.Array, jax.Array]:
    """Masked (depth, uniq) in the index's own ``ell_order``
    ([tier1, tier2, tier3, heavy, empty]) as single vectors — the parts
    op plus one device concatenate (the empty tail is a constant zero
    block); prefer the parts form on hot paths."""
    d1, u1, d2, u2, dh, uh = seg_depth_with_uniq_ell_parts(dg, path_mask)
    n = dg.num_segments
    if d2 is None and dh is None and not dg.ell_order.shape[0]:
        return d1[:n], u1[:n]
    nl, nm, nh, ne = _ell_class_sizes(dg)
    zero = jnp.zeros(ne, jnp.int32)
    dparts = [d1[:nl]] + (
        [d2[:nm]] if d2 is not None else []
    ) + ([dh[:nh]] if dh is not None else []) + [zero]
    uparts = [u1[:nl]] + (
        [u2[:nm]] if u2 is not None else []
    ) + ([uh[:nh]] if uh is not None else []) + [zero]
    return jnp.concatenate(dparts), jnp.concatenate(uparts)


def _compose_natural(dg: DeviceGraph, parts, q: Optional[int] = None):
    """Host composition of ELL part arrays into natural segment order:
    slice each present class to its true size, append the empty
    class's zeros, and invert ``ell_order``. ``parts`` is
    ``(d1, u1, d2, u2, dh, uh)`` of shape (cols,) or (Q, cols)."""
    d1, u1, d2, u2, dh, uh = parts
    n = dg.num_segments
    nl, nm, nh, ne = _ell_class_sizes(dg)
    lead = () if q is None else (q,)

    def host(x, cols):
        x = np.asarray(jax.device_get(x))[..., :cols]
        return x if q is None else x[:q]

    if d2 is None and dh is None and not dg.ell_order.shape[0]:
        return host(d1, n), host(u1, n)
    dparts, uparts = [host(d1, nl)], [host(u1, nl)]
    for d, u, cols in ((d2, u2, nm), (dh, uh, nh)):
        if d is not None:
            dparts.append(host(d, cols))
            uparts.append(host(u, cols))
    dparts.append(np.zeros(lead + (ne,), np.int32))
    uparts.append(np.zeros(lead + (ne,), np.int32))
    d = np.concatenate(dparts, axis=-1)
    u = np.concatenate(uparts, axis=-1)
    if not dg.ell_order.shape[0]:
        return d, u
    inv = np.empty(n, np.int64)
    inv[np.asarray(jax.device_get(dg.ell_order))] = np.arange(n)
    return d[..., inv], u[..., inv]


def seg_depth_with_uniq_ell(
    dg: DeviceGraph, path_mask: jax.Array
) -> Tuple[np.ndarray, np.ndarray]:
    """Masked (depth, uniq) via the tiered split ELL index, in natural
    segment order: the parts op plus host-side composition and
    un-permutation (numpy over the ingest-known ``ell_order``) — every
    consumer renders on the host, so the device pays neither the
    concatenate nor a gather."""
    return _compose_natural(dg, seg_depth_with_uniq_ell_parts(dg, path_mask))


def _best_masked_impl(dg: DeviceGraph) -> str:
    """The resident index a masked query runs on: the first present of
    the tiered ELL index, the crossing matrix, the run-level index and
    the step list. Each streams fewer bytes per query than the next
    wherever it is built (ELL ~4 B per run or 2 with pack16; the
    matrix P/2 B per segment; runs ~12 B per run; steps ~20 B per
    step)."""
    if dg.cross_ell.size:
        return "ell"
    if dg.cross_matrix.size:
        return "cross"
    if dg.run_path.shape[0]:
        return "runs"
    return "xla"


@jax.jit
def seg_depth_with_uniq_ell_batch_parts(
    dg: DeviceGraph, path_masks: jax.Array
):
    """Batched masked (depth, uniq) over the tiered split ELL index as
    per-class part arrays ``(d1, u1, d2, u2, dh, uh)`` of shape
    (Q, class_cols) — the batched analogue of
    seg_depth_with_uniq_ell_parts: the tier reductions vmap over the
    masks, and the heavy class becomes one (Q, P) x (P, NH) matmul.
    The heavy clip residual is already applied."""
    q = path_masks.shape[0]
    m = path_masks.astype(jnp.int32)[:, : dg.num_paths]
    pack16 = bool(dg.ell_pack16)
    tier_b = jax.vmap(
        functools.partial(_ellscan.tier_depth, pack16=pack16),
        in_axes=(None, 0),
    )
    d1, u1, d2, u2 = _fold_mid(dg, [tier_b(t, m) for t in _ell_tiers(dg)])
    dh = uh = None
    if dg.ell_heavy.size:
        mp = (
            jnp.zeros((q, dg.ell_heavy.shape[0] * 2), jnp.int32)
            .at[:, : dg.num_paths]
            .set(m)
        )
        dh, uh = batched_cross_depth(dg.ell_heavy, mp, nibble=True)
        if dg.ell_heavy_res_col.size:
            fix = jnp.einsum(
                "qp,pk->qk",
                mp,
                dg.ell_heavy_res,
                preferred_element_type=jnp.int32,
            )
            dh = dh.at[:, : dg.ell_heavy_res.shape[1]].add(fix)
    return d1, u1, d2, u2, dh, uh


# Largest batch per device call: bigger batches chunk (the per-batch
# fixed cost is already amortized ~32x at this size). Aliases the
# planner's nominal batch so tier plans amortize over the real serving
# batch size.
ELL_BATCH_CHUNK = _ellscan.ELL_BATCH_Q


def seg_depth_with_uniq_ell_batch(
    dg: DeviceGraph, path_masks: jax.Array
) -> Tuple[np.ndarray, np.ndarray]:
    """Batched tiered-ELL queries in natural segment order: the parts
    op plus HOST-side composition/un-permutation (a device-side inverse
    permutation would be an extra gather over Q x N values, and every
    consumer reads the results on the host anyway)."""
    q = path_masks.shape[0]
    if q > ELL_BATCH_CHUNK:
        halves = [
            seg_depth_with_uniq_ell_batch(
                dg, path_masks[i : i + ELL_BATCH_CHUNK]
            )
            for i in range(0, q, ELL_BATCH_CHUNK)
        ]
        return (
            np.concatenate([h[0] for h in halves])[:q],
            np.concatenate([h[1] for h in halves])[:q],
        )
    # Bucket Q to a power of two (zero-mask rows pad; results slice
    # back): every distinct Q would otherwise compile a fresh program
    # on the serving hot path. Buckets cap that at
    # log2(ELL_BATCH_CHUNK)+1 programs while keeping small-batch
    # latency near its own size's cost rather than a full chunk's.
    q_pad = 1 << (q - 1).bit_length()
    if q_pad != q:
        path_masks = jnp.concatenate(
            [
                jnp.asarray(path_masks),
                jnp.zeros(
                    (q_pad - q, path_masks.shape[1]), path_masks.dtype
                ),
            ]
        )
    return _compose_natural(
        dg, seg_depth_with_uniq_ell_batch_parts(dg, path_masks), q=q
    )


def seg_depth_with_uniq_batch(
    dg: DeviceGraph, path_masks: jax.Array
) -> Tuple[np.ndarray, np.ndarray] | Tuple[jax.Array, jax.Array]:
    """Many subset-depth queries at once: ``path_masks`` is bool[Q, P],
    returns (depth, uniq) of shape [Q, N] (host numpy on the ELL
    route, which composes on the host; device arrays otherwise).

    Routed like the single query (``_best_masked_impl``): the batched
    ELL reductions, then the crossing matrix (two matmuls,
    ``masks @ A`` — the read of A amortizes across all Q queries), then
    a vmap over the run-level or step-level pipeline. This is the shape
    production serving wants: one resident graph, a stream of subset
    queries.
    """
    impl = _best_masked_impl(dg)
    if impl == "ell":
        return seg_depth_with_uniq_ell_batch(dg, path_masks)
    if impl == "cross":
        return seg_depth_with_uniq_cross_batch(dg, path_masks)
    return _vmapped(_MASKED_IMPLS[impl])(dg, path_masks)


@functools.cache
def _vmapped(single):
    return jax.jit(jax.vmap(single, in_axes=(None, 0)))


@jax.jit
def seg_depth_with_uniq_cross_batch(
    dg: DeviceGraph, path_masks: jax.Array
) -> Tuple[jax.Array, jax.Array]:
    """Batched masked (depth, uniq) via the crossing matrix: two
    (Q, P) x (P, N) matmuls plus the residual sidecar fixup."""
    p_pad = dg.cross_matrix.shape[0] * (2 if dg.cross_nibble else 1)
    q = path_masks.shape[0]
    m = (
        jnp.zeros((q, p_pad), jnp.int32)
        .at[:, : dg.num_paths]
        .set(path_masks.astype(jnp.int32)[:, : dg.num_paths])
    )
    depth, uniq = batched_cross_depth(
        dg.cross_matrix, m, nibble=dg.cross_nibble
    )
    if dg.cross_res_seg.size:
        fix = jnp.einsum(
            "qp,pk->qk",
            m,
            dg.cross_res,
            preferred_element_type=jnp.int32,
        )
        depth = depth.at[:, dg.cross_res_seg].add(fix, mode="drop")
    return depth[:, : dg.num_segments], uniq[:, : dg.num_segments]


@jax.jit
def path_depth(dg: DeviceGraph) -> Tuple[jax.Array, jax.Array]:
    """(bp length, bp-weighted depth sum) per path.

    A path's mean depth is sum(seg_depth * seg_len over its steps)
    divided by its bp length (reference: ops/depth.rs:88-131); the
    division happens host-side in f64 for exact odgi float formatting.
    """
    seg_depth = dg.seg_bounds[1:] - dg.seg_bounds[:-1]
    step_seg = (dg.steps >> 1).astype(jnp.int32)
    lens = dg.seg_len[step_seg].astype(jnp.int64)
    weighted = seg_depth[step_seg].astype(jnp.int64) * lens
    path_len = bounded_segment_sum(lens, dg.path_bounds)
    path_sum = bounded_segment_sum(weighted, dg.path_bounds)
    return path_len, path_sum


# ---------------------------------------------------------------------------
# Host-side emitters (odgi-compatible TSV)
# ---------------------------------------------------------------------------


def format_float(x: float, digits: int) -> str:
    """odgi-style float: fixed digits, then strip trailing zeros/dot
    (reference: ops/depth.rs:192-197)."""
    return f"{x:.{digits}f}".rstrip("0").rstrip(".")


def seg_depth_table(
    g: GraphArrays, depths: np.ndarray, uniqs: np.ndarray
) -> str:
    names = g.seg_name.astype("U20")
    body = [
        f"{n}\t{d}\t{u}"
        for n, d, u in zip(names, np.asarray(depths), np.asarray(uniqs))
    ]
    return "\n".join(["#node.id\tdepth\tdepth.uniq"] + body) + "\n"


def path_depth_table(
    g: GraphArrays,
    lengths: np.ndarray,
    sums: np.ndarray,
    path_ids: Optional[Sequence[int]] = None,
) -> str:
    ids = range(g.num_paths) if path_ids is None else path_ids
    lines = ["#path\tstart\tend\tmean.depth"]
    for i in ids:
        mean = float(sums[i]) / float(lengths[i])
        lines.append(
            f"{g.path_name_bytes(i).decode()}\t0\t{int(lengths[i])}\t"
            f"{format_float(mean, 2)}"
        )
    return "\n".join(lines) + "\n"


def path_mask_for(g: GraphArrays, subset: Sequence[str]) -> np.ndarray:
    wanted = {s.encode() for s in subset}
    return np.array(
        [g.path_name_bytes(i) in wanted for i in range(g.num_paths)],
        dtype=bool,
    )


def run_seg_depth(
    g: GraphArrays,
    dg: DeviceGraph,
    subset_paths: Optional[List[str]] = None,
) -> str:
    """End-to-end segment depth query: device query + TSV rendering.
    Subset queries run on the index ``_best_masked_impl`` picks."""
    if subset_paths is None:
        depth, uniq = seg_depth_with_uniq(dg)
    else:
        mask = jnp.asarray(path_mask_for(g, subset_paths))
        depth, uniq = _MASKED_IMPLS[_best_masked_impl(dg)](dg, mask)
    return seg_depth_table(g, np.asarray(depth), np.asarray(uniq))


_MASKED_IMPLS = {
    "ell": seg_depth_with_uniq_ell,
    "cross": seg_depth_with_uniq_cross,
    "runs": seg_depth_with_uniq_runs,
    "xla": seg_depth_with_uniq_masked,
}


def run_seg_depth_batch(
    g: GraphArrays,
    dg: DeviceGraph,
    subsets: Sequence[Sequence[str]],
) -> str:
    """Many subset-depth queries in one device pass (the serving
    shape): one TSV table per subset, each preceded by ``##query i``.
    Routed like single queries (``_best_masked_impl``). No reference
    equivalent (fgfa answers one query per invocation)."""
    if not subsets:
        return ""
    masks = np.stack([path_mask_for(g, s) for s in subsets])
    depth, uniq = seg_depth_with_uniq_batch(dg, jnp.asarray(masks))
    depth = np.asarray(depth)
    uniq = np.asarray(uniq)
    out = []
    for i in range(masks.shape[0]):
        out.append(f"##query\t{i}\n")
        out.append(seg_depth_table(g, depth[i], uniq[i]))
    return "".join(out)


def run_path_depth(
    g: GraphArrays,
    dg: DeviceGraph,
    paths: Optional[List[str]] = None,
) -> str:
    lengths, sums = path_depth(dg)
    ids = None
    if paths is not None:
        by_name = {g.path_name_bytes(i): i for i in range(g.num_paths)}
        ids = [by_name[p.encode()] for p in paths if p.encode() in by_name]
    return path_depth_table(g, np.asarray(lengths), np.asarray(sums), ids)
