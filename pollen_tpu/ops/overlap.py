"""Path overlap: which paths share an oriented step with a query path
(reference semantics: slow_odgi/overlap.py).

TPU design: the pairwise set-intersection becomes a path × handle
incidence matrix multiplied with its own transpose on the MXU — one
bf16 matmul answers every path pair at once, instead of the reference's
per-pair Python set intersections.
"""

from __future__ import annotations

from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from ..device import DeviceGraph
from ..flatgfa import GraphArrays


def _incidence(g: GraphArrays) -> np.ndarray:
    """bool[P, 2N] — does path p use handle h (segment + orientation)?"""
    inc = np.zeros((g.num_paths, 2 * g.num_segments), dtype=bool)
    steps = np.asarray(g.steps, dtype=np.int64)
    inc[g.step_path_ids(), steps] = True
    return inc


@jax.jit
def _touch_matrix(inc: jax.Array) -> jax.Array:
    """bool[P, P]: do two (distinct) paths share any handle?"""
    m = inc.astype(jnp.bfloat16)
    # Exact for the > 0 test: 0/1 operands, and an f32 sum of
    # non-negative terms is 0 only when every term is.
    shared = jnp.dot(m, m.T, preferred_element_type=jnp.float32)
    touches = shared > 0
    return touches & ~jnp.eye(inc.shape[0], dtype=bool)


def run_overlap(
    g: GraphArrays, dg: DeviceGraph, query_paths: List[str]
) -> str:
    from .depth import path_depth

    by_name = {g.path_name_bytes(i).decode(): i for i in range(g.num_paths)}
    for q in query_paths:
        if q not in by_name:
            raise KeyError(f"no such path: {q}")

    touches = np.asarray(_touch_matrix(jnp.asarray(_incidence(g))))
    lengths, _ = path_depth(dg)
    lengths = np.asarray(lengths)

    lines = []
    for q in query_paths:
        qi = by_name[q]
        for other in range(g.num_paths):
            if touches[qi, other]:
                lines.append(
                    f"{q}\t0\t{int(lengths[qi])}\t"
                    f"{g.path_name_bytes(other).decode()}"
                )
    if not lines:
        return ""
    return "\n".join(["#path\tstart\tend\tpath.touched"] + lines) + "\n"
