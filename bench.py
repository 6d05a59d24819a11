"""Flagship benchmark: masked depth (+ unique depth) steps/s.

Times the subset-paths segment-depth query (odgi ``depth -d -s``
semantics): given a path mask, produce per-segment depth and
distinct-path counts on the index the router picks
(ops/depth._best_masked_impl; POLLEN_BENCH_IMPL=ell|cross|runs|xla
overrides). One process, one device; every timed call ends in
``jax.block_until_ready``.

Prints ONE JSON line on stdout:

    {"metric": ..., "value": N, "unit": "steps/s", "vs_baseline": N}

``vs_baseline``: speed-of-light time / achieved time. The irreducible
streaming formulation of masked depth reads each step's path id once
(4 B/step), so its speed-of-light time is ``n_steps * 4`` bytes over
the device's streaming bandwidth, measured in the same run. 1.0 == as
fast as a perfect single pass over the step list; > 1.0 == the
resident index beats dense streaming outright.

The device, its power limit and the timings go to stderr. Without a GPU
the run fails, unless the CPU is asked for with POLLEN_BENCH_PLATFORM=cpu
(tests). Shape knobs: POLLEN_BENCH_STEPS (default 2**22),
POLLEN_BENCH_SEGS, POLLEN_BENCH_PATHS, POLLEN_BENCH_REPS.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np


def synth_graph(
    n_steps: int, n_segs: int, n_paths: int, links: bool = False, seed: int = 8
):
    """A Zipf-crossed synthetic arena (no GFA text): segment popularity
    follows a Zipf law like real pangenomes, paths split the step list
    evenly and are named ``p0, p1, ...``. ``links=True`` adds one link
    per distinct consecutive step pair along the paths."""
    from pollen_tpu.flatgfa import GraphArrays

    rng = np.random.default_rng(seed)
    pop = rng.zipf(1.3, size=n_steps).astype(np.int64)
    segs = (pop - 1) % n_segs
    rev = rng.random(n_steps) < 0.1
    steps = (segs.astype(np.uint32) << np.uint32(1)) | rev.astype(np.uint32)

    bounds = np.linspace(0, n_steps, n_paths + 1).astype(np.uint32)
    path_steps = np.stack([bounds[:-1], bounds[1:]], axis=1)

    seg_lens = rng.integers(1, 32, size=n_segs).astype(np.uint32)
    seq_bounds = np.concatenate(([0], np.cumsum(seg_lens))).astype(np.uint32)
    seg_seq = np.stack([seq_bounds[:-1], seq_bounds[1:]], axis=1)

    names = [f"p{i}".encode() for i in range(n_paths)]
    name_ends = np.cumsum([len(x) for x in names], dtype=np.int64)
    path_name = np.stack(
        [np.concatenate(([0], name_ends[:-1])), name_ends], axis=1
    ).astype(np.uint32)

    link_from = link_to = np.zeros(0, np.uint32)
    if links:
        inner = np.ones(n_steps, bool)
        inner[bounds[1:] - 1] = False  # a path's last step links nowhere
        pairs = (steps[:-1].astype(np.uint64) << np.uint64(32)) | steps[1:]
        pairs = np.unique(pairs[inner[:-1]])
        link_from = (pairs >> np.uint64(32)).astype(np.uint32)
        link_to = (pairs & np.uint64(0xFFFFFFFF)).astype(np.uint32)

    return GraphArrays(
        header=np.zeros(0, np.uint8),
        seg_name=np.arange(1, n_segs + 1, dtype=np.int64),
        seg_seq=seg_seq,
        seg_optional=np.zeros((n_segs, 2), np.uint32),
        path_name=path_name,
        path_steps=path_steps,
        path_overlaps=np.zeros((n_paths, 2), np.uint32),
        link_from=link_from,
        link_to=link_to,
        link_overlap=np.zeros((link_from.size, 2), np.uint32),
        steps=steps,
        seq_data=np.zeros(int(seq_bounds[-1]), np.uint8),
        overlaps=np.zeros((0, 2), np.uint32),
        alignment=np.zeros(0, np.uint32),
        name_data=np.frombuffer(b"".join(names), np.uint8).copy(),
        optional_data=np.zeros(0, np.uint8),
        line_order=np.zeros(0, np.uint8),
    )


def synth_device_graph(
    n_steps: int, n_segs: int, n_paths: int, device=None
):
    """(arena, minimal DeviceGraph) for the synthetic graph.

    ``device="host"`` keeps every tensor in host numpy (see
    build_device_graph) so the caller can choose an impl first and ship
    only that impl's tensors (project_for_impl)."""
    from pollen_tpu.device import build_device_graph

    g = synth_graph(n_steps, n_segs, n_paths)
    return g, build_device_graph(g, minimal=True, device=device)


# Data fields each masked-depth impl reads (ops/depth.py); everything
# else is replaced by a zero-size leaf so the benchmark uploads only
# the index it measures.
_IMPL_FIELDS = {
    "ell": (
        "cross_ell",
        "cross_ell2",
        "cross_ell3",
        "ell_heavy",
        "ell_heavy_res",
        "ell_heavy_res_col",
    ),
    "cross": ("cross_matrix", "cross_res", "cross_res_seg"),
    "runs": ("run_path", "run_count", "run_seg_bounds"),
    "xla": ("step_path_sorted", "run_start", "seg_bounds"),
}


def project_host(dg, impl: str):
    """Zero-size every field ``impl`` does not read, staying in numpy.

    Returns a host DeviceGraph whose kept arrays are the originals and
    whose dropped arrays are empty (shape ``(0,) * ndim``, same dtype —
    the impl branches in ops/depth.py key on ``.size``/meta, never on
    dropped contents)."""
    import dataclasses

    keep = set(_IMPL_FIELDS[impl])
    out = {}
    for f in dataclasses.fields(dg):
        v = getattr(dg, f.name)
        if not hasattr(v, "ndim"):
            out[f.name] = v  # meta field
        elif f.name in keep:
            out[f.name] = np.asarray(v)
        else:
            out[f.name] = np.zeros((0,) * v.ndim, v.dtype)
    return type(dg)(**out)


def project_for_impl(dg, impl: str):
    """Ship ONLY the fields ``impl`` reads; zero-size the rest."""
    from pollen_tpu.device import upload

    return upload(project_host(dg, impl))


def _query_fn(impl: str):
    from pollen_tpu.ops import depth as depth_op

    if impl == "ell":
        return depth_op.seg_depth_with_uniq_ell_parts
    return depth_op._MASKED_IMPLS[impl]


def time_calls(fn, args, reps: int):
    """``(result, first-call s, [warm-call s] * reps)``: every call ends
    in ``jax.block_until_ready``; the first one compiles."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return out, first, times


def measure_depth(dg, reps: int, impl: str) -> float:
    """Median seconds per masked depth+uniq query on ``impl``'s index
    (the ELL route in its device parts form)."""
    import jax.numpy as jnp

    mask = jnp.zeros(dg.num_paths, jnp.bool_).at[::2].set(True)
    return statistics.median(time_calls(_query_fn(impl), (dg, mask), reps)[2])


def measure_stream_bandwidth(n: int = 2**25, reps: int = 20) -> float:
    """Device streaming bandwidth (B/s): one elementwise pass that
    reads and writes ``n`` int32 values, median of ``reps`` calls."""
    import jax
    import jax.numpy as jnp

    x = jnp.ones(n, dtype=jnp.int32)
    step = jax.jit(lambda x: (x * 3 + 1) ^ (x >> 1))
    return n * 8 / statistics.median(time_calls(step, (x,), reps)[2])


def card_name_and_power() -> str:
    """``name, power.limit`` of the card as nvidia-smi reports it."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def main() -> int:
    plat = os.environ.get("POLLEN_BENCH_PLATFORM")
    if plat:
        import jax

        jax.config.update("jax_platforms", plat)
    import jax

    from pollen_tpu.device import build_device_graph, on_gpu
    from pollen_tpu.ops.depth import _best_masked_impl

    if not on_gpu() and plat != "cpu":
        print(
            f"bench: no GPU (JAX device {jax.devices()[0].platform!r}); set "
            "POLLEN_BENCH_PLATFORM=cpu to time the CPU on purpose",
            file=sys.stderr,
        )
        return 1
    dev = jax.devices()[0]
    card = card_name_and_power() if on_gpu() else "no GPU"
    print(f"# device {dev.platform} {dev.device_kind} x"
          f"{len(jax.devices())} ({card})", file=sys.stderr)

    n_steps = int(os.environ.get("POLLEN_BENCH_STEPS", 2**22))
    n_segs = int(os.environ.get("POLLEN_BENCH_SEGS", 2**18))
    n_paths = int(os.environ.get("POLLEN_BENCH_PATHS", 128))
    reps = int(os.environ.get("POLLEN_BENCH_REPS", 50))

    t0 = time.perf_counter()
    g = synth_graph(n_steps, n_segs, n_paths)
    dg_host = build_device_graph(g, minimal=True, device="host")
    impl = os.environ.get("POLLEN_BENCH_IMPL") or _best_masked_impl(dg_host)
    dg = project_for_impl(dg_host, impl)
    jax.block_until_ready(dg)
    print(f"# ingest+upload {time.perf_counter() - t0:.2f}s, impl {impl}",
          file=sys.stderr)

    per_query = measure_depth(dg, reps, impl)
    bandwidth = measure_stream_bandwidth()
    print(f"# {per_query * 1e6:.1f} us/query (median of {reps}); stream "
          f"{bandwidth / 1e9:.1f} GB/s", file=sys.stderr)
    sol_time = n_steps * 4.0 / bandwidth
    print(
        json.dumps(
            {
                "metric": "masked_depth_steps_per_s",
                "value": round(n_steps / per_query),
                "unit": "steps/s",
                "vs_baseline": round(sol_time / per_query, 4),
            }
        ),
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
