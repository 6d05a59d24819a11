"""ELL-packed run index: masked depth + uniq with no boundary stage and
no dense (path, segment) matrix.

The run-level index (device.py) is a sparse matrix: per segment, the
list of (path, count) crossings. This module stores it ELLPACK-style —
``K`` fixed slots per segment column, each an int32 packing
``path << 16 | count`` (empty slots are 0) — so the masked depth query
is a short, regular reduction over the slot axis:

    depth[s] = sum_k  mask[path(v_ks)] * count(v_ks)
    uniq[s]  = sum_k  mask[path(v_ks)] * (v_ks != 0)

Tiers are stored flat, ``(K, cols)``: column-major reads coalesce, and
XLA fuses the slot unpack, the mask gather and the K-slot sum into one
reduction. Graphs with <= 256 paths store the pack16 paired form
(pair_ell16): two 16-bit ``path << 8 | count`` slots per int32 word.

Segments with more than K runs (or any count >= 2**16) are routed
whole to the heavy nibble sub-matrix (device.py), which restores both
depth and uniq with one mat-vec plus a small clip residual.

Reference semantics: flatgfa/src/ops/depth.rs:15-39.
"""

from __future__ import annotations

import functools
import itertools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

LANES = 128
COUNT_BITS = 16
COUNT_MAX = (1 << COUNT_BITS) - 1


# Tier-planner cost weights, in "equivalent streamed bytes". They are
# NOT yet fit on the H100: they keep the relative shape of the model —
# a per-slot term that grows with the mask word count, a per-column
# term for the two output writes, a per-tier fixed cost and a per-byte
# heavy term — until a trace of the card's tier times refits them.
C_COL_B = 5.25  # per tier column (output writes)
C_HEAVY_PER_PATH = 0.74
C_HEAVY_PER_BYTE = 2 * C_HEAVY_PER_PATH
C_TIER_FIXED = 1.3e6  # per extra tier (one more reduction launched)
# Nominal batch the "batch" planning objective amortizes fixed costs
# over. This IS the serving batch size: ops/depth.py chunks batches at
# this Q (its ELL_BATCH_CHUNK aliases this constant).
ELL_BATCH_Q = 32


def c_slot_a(n_words: int = 4) -> float:
    """Marginal per-slot cost: unpack + mask lookup + two MACs, growing
    with the number of 32-path mask words."""
    return 1.15 + 0.7 * max(n_words - 1, 1)


def plan_ell_tiers_n(
    runs_per_seg: np.ndarray,
    big_seg: np.ndarray,
    p_pad: int,
    max_tiers: int = 3,
    objective: str = "single",
):
    """Up-to-``max_tiers``-way sliced-ELL split: tier t's columns get
    K_t slots (K_1 < K_2 < ...); the rest of the crossed segments go
    dense ("heavy"). Crossing counts follow a Zipf law, so one small K
    wastes slots on mid-popularity segments, while every extra tier
    pays a fixed cost (C_TIER_FIXED). Segments no path crosses are
    excluded from every class — their depth/uniq are identically zero
    at ingest and buy no device work at all.

    ``objective``: "single" charges each tier its full fixed cost (a
    Q=1 query pays every launch); "batch" amortizes it over a nominal
    batch (the batched query reads each slot block once per batch, so
    per-QUERY cost is slot-dominated and finer tiers win).

    Returns ``(ks, tiers, heavy_mask)``: ``ks`` a tuple of slot counts
    (possibly length < max_tiers), ``tiers`` the matching list of
    bool masks, ``heavy_mask`` the dense remainder. ``ks`` is empty
    only when no crossed segment fits any K (all heavy)."""
    crossed = runs_per_seg > 0
    valid = ~big_seg & crossed

    def pad(n: int) -> int:
        return -(-n // LANES) * LANES

    n_crossed = int(crossed.sum())
    n_words = max(-(-p_pad // 32), 1)
    a = c_slot_a(n_words)
    # Batch objective: the batched query amortizes per-tier fixed cost
    # AND the heavy unpack/matmul over the serving batch (ELL_BATCH_Q);
    # what stays per-query is the per-slot work and the output writes
    # per column (~8 B).
    if objective == "single":
        tier_fixed = C_TIER_FIXED
        heavy_per_col = C_HEAVY_PER_PATH * p_pad
    else:
        tier_fixed = C_TIER_FIXED / ELL_BATCH_Q
        heavy_per_col = C_HEAVY_PER_PATH * p_pad / ELL_BATCH_Q + 8
    kset = (1, 2, 4, 8, 16, 32)
    # One O(n) pass per candidate K; the 41-combination search then
    # works on the 6-entry cumulative counts (ks are ascending, so a
    # tier's count is a difference of two of them). Masks materialize
    # only for the winning plan.
    c_le = {k: int((valid & (runs_per_seg <= k)).sum()) for k in kset}
    best = None
    for size in range(1, max_tiers + 1):
        for ks in itertools.combinations(kset, size):
            counts = []
            prev_le = 0
            ok = True
            for k in ks:
                n_t = c_le[k] - prev_le
                if n_t == 0:
                    ok = False  # equivalent to a smaller subset
                    break
                counts.append(n_t)
                prev_le = c_le[k]
            if not ok:
                continue
            nh = n_crossed - sum(counts)
            cost = sum(
                tier_fixed + (a * k + C_COL_B) * pad(n_t)
                for k, n_t in zip(ks, counts)
            )
            if nh:
                cost += tier_fixed + heavy_per_col * nh
            if best is None or cost < best[0]:
                best = (cost, ks)
    if best is None:
        # No crossed segment fits any K: everything heavy (the ingest
        # gate then skips ELL and the dense/run indexes serve).
        return (), [], crossed.copy()
    _, ks = best
    masks = []
    prev = np.zeros_like(valid)
    for k in ks:
        t = valid & (runs_per_seg <= k) & ~prev
        masks.append(t)
        prev = prev | t
    return ks, masks, crossed & ~prev


def plan_ell_tiers(
    runs_per_seg: np.ndarray,
    big_seg: np.ndarray,
    p_pad: int,
) -> Tuple[int, int, np.ndarray, np.ndarray, np.ndarray]:
    """Two-tier compatibility form of :func:`plan_ell_tiers_n`.

    Returns ``(k1, k2, tier1_mask, tier2_mask, heavy_mask)`` with
    ``k2 == 0`` (and an all-false tier2) when a middle tier does not
    pay; the remainder (``~t1 & ~t2 & ~heavy``) is the empty class."""
    ks, masks, heavy = plan_ell_tiers_n(
        runs_per_seg, big_seg, p_pad, max_tiers=2
    )
    empty = np.zeros_like(heavy)
    if not ks:
        return 1, 0, empty, empty, heavy
    if len(ks) == 1:
        return ks[0], 0, masks[0], empty, heavy
    return ks[0], ks[1], masks[0], masks[1], heavy


def plan_ell(
    runs_per_seg: np.ndarray,
    big_seg: np.ndarray,
    p_pad: int,
) -> Tuple[int, np.ndarray]:
    """Pick K in {1, 2, 4, 8, 16} and the heavy-segment split.

    A segment is *heavy* for a given K when its runs overflow K slots
    (or any count overflows the 16-bit packing — ``big_seg``). Heavy
    segments move whole to the nibble-packed sub-matrix sidecar, so the
    streamed cost is ``4 K`` bytes per light column plus ``p_pad / 2``
    bytes per heavy column; minimize over K. Returns ``(k, heavy)``
    with ``heavy`` a bool mask over segments."""
    best = None
    for k in (1, 2, 4, 8, 16):
        heavy = (runs_per_seg > k) | big_seg
        nh = int(heavy.sum())
        nl = runs_per_seg.shape[0] - nh
        nl_pad = -(-max(nl, 1) // LANES) * LANES
        nh_pad = -(-nh // LANES) * LANES if nh else 0
        cost = 4 * k * nl_pad + (p_pad // 2) * nh_pad
        if best is None or cost < best[0]:
            best = (cost, k, heavy)
    return best[1], best[2]


def pack_ell(
    run_path: np.ndarray,
    run_count: np.ndarray,
    run_col: np.ndarray,
    slot: np.ndarray,
    k: int,
    n_cols_pad: int,
) -> np.ndarray:
    """Pack runs into int32[K, n_cols_pad] ELL slots
    (``path << 16 | count``; empty slots 0). ``run_col`` is each run's
    column, ``slot`` its slot index (must be < K, counts <= COUNT_MAX —
    the caller routed overflowing segments to the heavy sidecar)."""
    ell = np.zeros((k, n_cols_pad), np.int32)
    ell[slot, run_col] = (
        run_path.astype(np.int32) << COUNT_BITS
    ) | run_count.astype(np.int32)
    return ell


def build_ell(
    run_path: np.ndarray,
    run_count: np.ndarray,
    run_seg: np.ndarray,
    num_segments: int,
    k: int | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Pack the run-level index into ELL slots over ALL segments
    (heavy columns left empty) — the pre-split layout, kept for direct
    kernel tests and small graphs.

    Returns ``(ell, heavy_segs)``: ``ell`` is int32[K, N_pad] with
    ``path << 16 | count`` per slot, zero-padded; ``heavy_segs`` lists
    segments whose runs did NOT fit (too many runs or count overflow).
    Runs must arrive segment-grouped (the (segment, path) sort order of
    device.py ingest).
    """
    n_pad = -(-max(num_segments, 1) // LANES) * LANES
    runs_per_seg = np.bincount(run_seg, minlength=num_segments)
    big_seg = np.zeros(num_segments, bool)
    big_seg[run_seg[run_count > COUNT_MAX]] = True
    if k is None:
        p = int(run_path.max(initial=0)) + 1
        p_pad = -(-max(p, 1) // LANES) * LANES
        k, heavy_b = plan_ell(runs_per_seg, big_seg, p_pad)
    else:
        heavy_b = (runs_per_seg > k) | big_seg
    heavy = np.flatnonzero(heavy_b).astype(np.int32)
    # Slot index of each run within its segment (runs are grouped).
    seg_starts = np.concatenate(([0], np.cumsum(runs_per_seg)))
    slot = np.arange(run_seg.size, dtype=np.int64) - seg_starts[run_seg]
    keep = ~heavy_b[run_seg]
    ell = pack_ell(
        run_path[keep], run_count[keep], run_seg[keep], slot[keep], k, n_pad
    )
    return ell, heavy


def pair_ell16(ell: np.ndarray) -> np.ndarray:
    """int32[K, N] ``path<<16|count`` slots -> int32[ceil(K/2), N]
    words holding TWO 16-bit ``path<<8|count`` slots (low half = even
    slot). Requires paths < 256 and counts <= 255 — the compact form
    for haplotype-scale graphs (HPRC pangenomes carry ~90-100 paths);
    callers route larger counts to the heavy class."""
    path = (ell >> 16) & 0xFFFF
    cnt = ell & 0xFFFF
    assert int(path.max(initial=0)) < 256, "pack16 needs path ids < 256"
    assert int(cnt.max(initial=0)) < 256, "pack16 needs counts <= 255"
    h = ((path.astype(np.int64) << 8) | cnt.astype(np.int64))
    if h.shape[0] % 2:
        h = np.concatenate([h, np.zeros((1, h.shape[1]), h.dtype)])
    pair = (h[1::2] << 16) | h[0::2]
    return (pair & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


def unpair_ell16(paired):
    """Inverse of :func:`pair_ell16` up to slot order: int32[Kw, N]
    paired words -> int32[2*Kw, N] standard ``path<<16|count`` slots
    (slot order is permuted — even halves first — which is irrelevant
    to the slot-sum reductions; a padded zero half stays a zero slot).
    Works on numpy or jax arrays."""
    xp = jnp if isinstance(paired, jax.Array) else np

    def expand(h):
        return (((h >> 8) & 0xFF) << COUNT_BITS) | (h & 0xFF)

    lo = paired & 0xFFFF
    hi = (paired >> 16) & 0xFFFF
    return xp.concatenate([expand(lo), expand(hi)], axis=0)


def pack_mask_words(mask: jax.Array, n_words: int) -> jax.Array:
    """Pack a 0/1 path mask into int32 bit words (path p -> bit p%32 of
    word p//32)."""
    p_pad = n_words * 32
    m = jnp.zeros(p_pad, jnp.int32).at[: mask.shape[0]].set(
        mask.astype(jnp.int32)
    )
    shifted = m.reshape(n_words, 32) << jnp.arange(32, dtype=jnp.int32)
    return jnp.sum(shifted, axis=1).astype(jnp.int32)


@jax.jit
def masked_ell_depth_xla(
    ell: jax.Array, mask: jax.Array
) -> Tuple[jax.Array, jax.Array]:
    """(depth, uniq) per column of int32[K, N] ``path<<16|count`` slots:
    slot unpack, mask gather and K-slot sum, fused by XLA into one
    reduction. Paths beyond the mask's length count as unselected."""
    pid = (ell >> COUNT_BITS) & 0xFFFF  # zero-extend: >> is arithmetic
    cnt = ell & COUNT_MAX
    bit = jnp.take(
        mask.astype(jnp.int32), pid, mode="fill", fill_value=0
    )
    depth = jnp.sum(bit * cnt, axis=0)
    uniq = jnp.sum(bit * (ell != 0).astype(jnp.int32), axis=0)
    return depth, uniq


@functools.partial(jax.jit, static_argnames=("pack16",))
def tier_depth(
    tier: jax.Array, mask: jax.Array, pack16: bool = False
) -> Tuple[jax.Array, jax.Array]:
    """(depth, uniq) per column of one stored tier (pack16 storage is
    unpaired in-trace; XLA fuses the unpair into the reduction)."""
    return masked_ell_depth_xla(unpair_ell16(tier) if pack16 else tier, mask)
