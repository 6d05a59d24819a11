"""Crossing-matrix depth: masked depth + uniq as matrix products.

The run-level index (device.py) densified over (path, segment) is a
matrix ``A[p, n] = number of steps of segment n on path p`` — the
graph's crossing histogram. With it, the masked depth query is linear
algebra, not data movement:

    depth = mask @ A          (crossings per segment)
    uniq  = mask @ min(A, 1)  (distinct selected paths per segment)

No gathers, no scatters, no scan: one streamed read of A, with outputs
landing directly at segment granularity. Batched queries become a real
matmul, ``masks @ A``, amortizing the single read of A across Q masks.

Storage: counts clip at a small maximum and the clipped remainders
move to a dense **residual sidecar** (device.py) — crossings follow a
Zipf law, so the overflowing cells cluster in a few hundred popular
segments; a (P_pad, K_pad) int32 matrix over just those segment
columns restores exact depth with one tiny extra dot + a K-sized
scatter instead of a per-cell COO scatter. Two on-device layouts:

* **nibble** (default): two path rows per byte, counts clipped at 15
  — 0.5 bytes of device memory per cell. The unpack splits each byte
  into low/high nibbles, giving the unpacked rows in [0::2 | 1::2]
  order; the *mask* is permuted to match (``fold_mask``), which leaves
  the dot's result identical because the contraction is over paths.
* **int8**: counts clipped at 127, 1 byte per cell — the fallback
  when a graph's residual sidecar under nibble clipping would out-
  weigh the packing savings.

Reference semantics: flatgfa/src/ops/depth.rs:15-39. The dense form
trades device memory for a gather-free query; device.py builds it only
under a size budget.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

LANES = 128
CLIP = 127  # largest count stored per int8 cell
CLIP_NIBBLE = 15  # largest count stored per nibble cell
# Segment id of residual-sidecar padding columns: out of range for any
# depth vector and any column shard, so mode="drop" scatters skip it.
RES_SENTINEL = 2**30


def fold_mask(mask: jax.Array, axis: int = 0) -> jax.Array:
    """Reorder a path-indexed vector (or the path axis of a batch of
    masks) into the row order the nibble unpack produces: even source
    rows first (low nibbles), then odd rows (high nibbles)."""
    even = jax.lax.slice_in_dim(mask, 0, None, stride=2, axis=axis)
    odd = jax.lax.slice_in_dim(mask, 1, None, stride=2, axis=axis)
    return jnp.concatenate([even, odd], axis=axis)


def unpack_cross(cross: jax.Array) -> jax.Array:
    """Nibble unpack: uint8 (P/2, N) -> int32 (P, N) in [0::2 | 1::2]
    row order (pair with ``fold_mask``)."""
    t = cross.astype(jnp.int32)
    return jnp.concatenate([t & 15, t >> 4], axis=0)


@functools.partial(jax.jit, static_argnames=("nibble",))
def masked_cross_depth_xla(
    cross: jax.Array, mask: jax.Array, nibble: bool = False
) -> Tuple[jax.Array, jax.Array]:
    """(depth, uniq) int32[N_pad] for one mask: a masked column sum in
    int32 (exact; no float rounding mode applies). Written as a
    multiply-reduce rather than a dot so XLA fuses the unpack into one
    pass over the packed bytes."""
    if nibble:
        a = unpack_cross(cross)
        mask = fold_mask(mask)
    else:
        a = cross.astype(jnp.int32)
    m = mask.astype(jnp.int32)[:, None]
    depth = jnp.sum(m * a, axis=0, dtype=jnp.int32)
    uniq = jnp.sum(m * (a > 0), axis=0, dtype=jnp.int32)
    return depth, uniq


@functools.partial(jax.jit, static_argnames=("nibble",))
def batched_cross_depth(
    cross: jax.Array, masks: jax.Array, nibble: bool = False
) -> Tuple[jax.Array, jax.Array]:
    """(depth, uniq) int32[Q, N_pad] for Q masks at once: two matmuls
    reading A once each — the serving shape (one resident graph, a
    stream of subset queries). XLA materializes an unpacked bf16 copy
    of A before the matmul; a fused dequantizing GEMM would stream the
    packed bytes instead."""
    if nibble:
        a = unpack_cross(cross).astype(jnp.bfloat16)
        masks = fold_mask(masks, axis=1)
    else:
        a = cross.astype(jnp.bfloat16)
    m = masks.astype(jnp.bfloat16)
    # Exact: operands are 0/1 masks and counts <= 127 (bf16 holds every
    # integer up to 256), and f32 accumulation is exact below 2**24.
    depth = jnp.dot(m, a, preferred_element_type=jnp.float32)
    uniq = jnp.dot(
        m, jnp.minimum(a, jnp.bfloat16(1)), preferred_element_type=jnp.float32
    )
    return depth.astype(jnp.int32), uniq.astype(jnp.int32)
