"""End-to-end smoke run of pollen-tpu's main path on a GPU.

    python chip_smoke.py [--steps N]     # one GPU: phases 1-4
    python chip_smoke.py --cards 4       # four GPUs: the sharded paths

Phases (one process; any failure exits non-zero before the last line):

1. device check — no GPU means exit 1; prints the card's name and
   power limit, the jax/jaxlib versions, XLA_FLAGS and the compile
   cache directory;
2. fixtures — ``fgfa-tpu -I tests/graphs/*.gfa`` depth/subset depth/
   degree/paths through ``pollen_tpu.cli.main``, byte-compared with
   ``tests/golden/``;
3. every masked-depth route at the 2^22-step regression shape
   (synthetic, Zipf-crossed, 2^18 segments, 128 paths), each checked
   exactly against a NumPy reference built from the raw arena and
   timed (first call, and the median of >= 50 warm calls ended by
   ``jax.block_until_ready``), and the served single query (device
   query, host compose, TSV render) timed;
4. the served path at chromosome scale (default 10^8 steps, 2^22
   segments, 96 paths): the arena is saved as FlatGFA and served with
   ``fgfa-tpu -i <file> serve``; every served table is parsed back and
   compared exactly with the NumPy reference; stage times and the
   device's peak memory are printed.

With ``--cards 4`` only the sharded paths run (step-sharded scan with
replicated and reduce-scatter outputs, column-sharded crossing matrix,
column-sharded ELL single and batch, sharded degree) at the chromosome
shape, each compared with the single-card answer on card 0.

The last stdout line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import pathlib
import statistics
import sys
import tempfile
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

SHAPE_ROUTES = (2**22, 2**18, 128)  # regression shape of phase 3
CHR8_SEGS, CHR8_PATHS = 2**22, 96  # chromosome-scale deployment
WARM_CALLS = 50


def log(msg: str) -> None:
    print(msg, flush=True)


def time_route(fn, *args, warm: int = WARM_CALLS):
    """(result, first-call s, warm median s, warm IQR s)."""
    import bench

    out, first, times = bench.time_calls(fn, args, warm)
    q1, _, q3 = statistics.quantiles(times, n=4)
    return out, first, statistics.median(times), q3 - q1


def fmt_route(name: str, first: float, warm: float, iqr: float) -> str:
    return (
        f"  {name:<28} first call {first:8.3f} s   warm median "
        f"{warm * 1e6:10.1f} us (IQR {iqr * 1e6:.1f} us)"
    )


class Reference:
    """Masked depth answers computed with NumPy from the raw arena,
    independent of the device index: depth is a bincount over the steps
    of the selected paths, uniq a bincount over their distinct
    (segment, path) pairs."""

    def __init__(self, g):
        self.n, self.p = g.num_segments, g.num_paths
        self.segs = (np.asarray(g.steps) >> 1).astype(np.int64)
        self.paths = g.step_path_ids()
        pairs = np.unique(self.segs * self.p + self.paths)
        self.pair_seg, self.pair_path = pairs // self.p, pairs % self.p

    def depth(self, mask):
        mask = np.asarray(mask, bool)
        return (
            np.bincount(self.segs[mask[self.paths]], minlength=self.n),
            np.bincount(self.pair_seg[mask[self.pair_path]], minlength=self.n),
        )


def check_equal(name: str, got, want) -> None:
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), name)


def phase_device() -> None:
    import jax
    import jaxlib

    import bench

    log(bench.card_name_and_power())  # "name, power.limit" per card
    log(f"jax {jax.__version__}, jaxlib {jaxlib.__version__}; "
        f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}; compile cache "
        f"{jax.config.jax_compilation_cache_dir}")
    log(f"devices: {jax.devices()}")


def run_cli(argv, stdin=None) -> str:
    """``pollen_tpu.cli.main(argv)`` in this process, with ``stdin``
    (an iterable of lines) in place of standard input; returns what it
    wrote to stdout."""
    from pollen_tpu import cli

    out = io.StringIO()
    old_stdin = sys.stdin
    if stdin is not None:
        sys.stdin = stdin
    try:
        with contextlib.redirect_stdout(out):
            cli.main(argv)
    finally:
        sys.stdin = old_stdin
    return out.getvalue()


def phase_fixtures() -> int:
    graphs = sorted((REPO / "tests" / "graphs").glob("*.gfa"))
    golden = REPO / "tests" / "golden"
    checked = 0
    t0 = time.perf_counter()
    for gfa in graphs:
        stem = gfa.stem
        for argv, gold in (
            (["depth", "-d"], f"{stem}.depth"),
            (["depth", "-d", "-s", str(golden / f"{stem}.depthpaths")],
             f"{stem}.depth_subset"),
            (["degree"], f"{stem}.degree"),
            (["paths"], f"{stem}.paths"),
        ):
            got = run_cli(["-I", str(gfa), *argv])
            if got != (golden / gold).read_text():
                raise AssertionError(f"{gfa.name} {' '.join(argv)} != {gold}")
            checked += 1
    log(f"fixtures: {checked} outputs of {len(graphs)} graphs byte-identical "
        f"to tests/golden ({time.perf_counter() - t0:.1f} s)")
    return checked


def phase_routes(shape=SHAPE_ROUTES, warm: int = WARM_CALLS) -> dict:
    """Every masked-depth route at ``shape``; returns the warm medians."""
    import jax
    import jax.numpy as jnp

    import bench
    from pollen_tpu.device import build_device_graph, upload
    from pollen_tpu.ops import depth as D
    from pollen_tpu.ops.degree import seg_degree

    n_steps, n_segs, n_paths = shape
    t0 = time.perf_counter()
    g = bench.synth_graph(n_steps, n_segs, n_paths, links=True)
    dg_host = build_device_graph(g, device="host")
    dg = jax.block_until_ready(upload(dg_host))
    ref = Reference(g)
    log(f"routes: S={n_steps} N={n_segs} P={n_paths}, ingest+reference "
        f"{time.perf_counter() - t0:.1f} s; ELL ks=({dg.ell_k},{dg.ell_k2},"
        f"{dg.ell_k3}) pack16={dg.ell_pack16} classes l/m/m2/h="
        f"{dg.ell_num_light}/{dg.ell_num_mid}/{dg.ell_num_mid2}/"
        f"{dg.ell_num_heavy}; cross {dg.cross_matrix.shape} "
        f"nibble={dg.cross_nibble}")
    assert dg.cross_ell.size and dg.cross_matrix.size

    rng = np.random.default_rng(5)
    mask_np = rng.integers(0, 2, n_paths).astype(bool)
    masks_np = rng.integers(0, 2, (32, n_paths)).astype(bool)
    mask, masks = jnp.asarray(mask_np), jnp.asarray(masks_np)
    want = ref.depth(mask_np)
    want_b = [ref.depth(m) for m in masks_np]
    warm_s = {}

    def route(name, fn, *args, check=None, n=warm):
        out, first, med, iqr = time_route(fn, *args, warm=n)
        (check or (lambda o: check_equal(name, o, want)))(out)
        warm_s[name] = (med, iqr)
        log(fmt_route(name, first, med, iqr))
        return out

    route("ell parts", D.seg_depth_with_uniq_ell_parts, dg, mask,
          check=lambda o: check_equal("ell", D._compose_natural(dg, o), want))
    route("ell natural order", D.seg_depth_with_uniq_ell, dg, mask)

    def check_batch(name, d, u):
        for q in range(len(want_b)):
            check_equal(f"{name} q{q}", (d[q], u[q]), want_b[q])

    route("ell batch Q=32 (parts)", D.seg_depth_with_uniq_ell_batch_parts,
          dg, masks, check=lambda o: check_batch(
              "ell batch", *D._compose_natural(dg, o, q=32)))
    route("cross", D.seg_depth_with_uniq_cross, dg, mask)
    route("cross batch Q=32", D.seg_depth_with_uniq_cross_batch, dg, masks,
          check=lambda o: check_batch("cross batch", *o))
    route("runs (run-level XLA)", D.seg_depth_with_uniq_runs, dg, mask)
    route("steps (step-level XLA)", D.seg_depth_with_uniq_masked, dg, mask)

    seg_all = np.bincount(ref.segs, minlength=n_segs)
    lens = np.asarray(g.seg_len).astype(np.int64)
    bounds = np.asarray(g.path_steps).astype(np.int64)
    path_len = np.array([lens[ref.segs[a:b]].sum() for a, b in bounds])
    path_sum = np.array(
        [(seg_all[ref.segs[a:b]] * lens[ref.segs[a:b]]).sum() for a, b in bounds]
    )
    route("path_depth (int64)", D.path_depth, dg,
          check=lambda o: check_equal("path_depth", o, (path_len, path_sum)))
    deg = np.bincount(np.asarray(g.link_from) >> 1, minlength=n_segs) + \
        np.bincount(np.asarray(g.link_to) >> 1, minlength=n_segs)
    route("degree", seg_degree, dg,
          check=lambda o: check_equal("degree", (o,), (deg,)))

    # The served single query: device query, host compose, TSV render.
    subset = [f"p{i}" for i in np.flatnonzero(mask_np)]
    route("served single query", D.run_seg_depth, g, dg, subset, n=20,
          check=lambda o: check_equal(
              "served", parse_table(o)[:, 1:].T, want))
    return warm_s


class Spans:
    """Wall time of named functions while installed: each wrapped
    call's (start, seconds) is recorded under its label."""

    def __init__(self):
        self.calls = {}
        self._undo = []

    def wrap(self, module, attr, label, block=False):
        import jax

        orig = getattr(module, attr)

        def timed(*a, **kw):
            t0 = time.perf_counter()
            out = orig(*a, **kw)
            if block:
                out = jax.block_until_ready(out)
            self.calls.setdefault(label, []).append(
                (t0, time.perf_counter() - t0)
            )
            return out

        setattr(module, attr, timed)
        self._undo.append((module, attr, orig))

    def restore(self):
        for module, attr, orig in reversed(self._undo):
            setattr(module, attr, orig)

    def total(self, label, lo=0.0, hi=float("inf")):
        return sum(d for t, d in self.calls.get(label, []) if lo <= t < hi)


class TimedLines:
    """A stdin stand-in that records when each request line is taken:
    request i runs from ``stamps[i]`` to ``stamps[i + 1]``."""

    def __init__(self, lines):
        self.lines, self.stamps = lines, []

    def __iter__(self):
        for line in self.lines:
            self.stamps.append(time.perf_counter())
            yield line + "\n"
        self.stamps.append(time.perf_counter())


def parse_table(text: str) -> np.ndarray:
    """A served ``#node.id depth depth.uniq`` TSV -> int64[N, 3]."""
    head, _, body = text.partition("\n")
    assert head == "#node.id\tdepth\tdepth.uniq", head
    return np.fromstring(body.replace("\t", " "), dtype=np.int64, sep=" ").reshape(-1, 3)


def phase_served(n_steps: int) -> None:
    import jax

    import bench
    from pollen_tpu import device, fileformat
    from pollen_tpu.ops import depth as depth_mod

    stage = {}
    t0 = time.perf_counter()
    g = bench.synth_graph(n_steps, CHR8_SEGS, CHR8_PATHS)
    stage["synth"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = Reference(g)
    t_ref = time.perf_counter() - t0

    rng = np.random.default_rng(8)
    subsets = [
        sorted(rng.choice(CHR8_PATHS, size=k, replace=False).tolist())
        for k in (48, 17, 80, 5, 33, 64, 91)
    ]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        flat = tmp / "chr8.flatgfa"
        t0 = time.perf_counter()
        fileformat.save_flatgfa(str(flat), g)
        stage["save"] = time.perf_counter() - t0
        files = []
        for i, sub in enumerate(subsets[:3]):
            f = tmp / f"subset{i}.txt"
            f.write_text("".join(f"p{j}\n" for j in sub))
            files.append(f)
        batch = tmp / "batch.txt"
        batch.write_text("".join(
            ",".join(f"p{j}" for j in sub) + "\n" for sub in subsets[3:]
        ))
        requests = TimedLines(
            ["depth -d"]
            + [f"depth -d -s {f}" for f in files]
            + [f"depth -S {batch}", "paths"]
        )
        spans = Spans()
        spans.wrap(fileformat, "load_flatgfa", "load")
        spans.wrap(device, "build_host_index", "index build")
        spans.wrap(device, "upload", "upload", block=True)
        spans.wrap(depth_mod, "seg_depth_table", "render")
        try:
            out = run_cli(["-i", str(flat), "serve"], stdin=requests)
        finally:
            spans.restore()
    st = requests.stamps
    frames = out.split("##end\tok\n")
    assert len(frames) == 7 and frames[-1] == "", [f[-200:] for f in frames]

    def check_table(name, text, mask):
        got = parse_table(text)
        np.testing.assert_array_equal(got[:, 0], np.arange(1, CHR8_SEGS + 1))
        d, u = ref.depth(mask) if mask is not None else (
            np.bincount(ref.segs, minlength=CHR8_SEGS),
            np.bincount(ref.pair_seg, minlength=CHR8_SEGS),
        )
        check_equal(name, (got[:, 1], got[:, 2]), (d, u))

    def mask_of(sub):
        m = np.zeros(CHR8_PATHS, bool)
        m[sub] = True
        return m

    check_table("depth -d", frames[0], None)
    for i in range(3):
        check_table(f"subset {i}", frames[1 + i], mask_of(subsets[i]))
    tables = frames[4].split("##query\t")[1:]
    assert len(tables) == 4
    for i, t in enumerate(tables):
        idx, _, t = t.partition("\n")
        assert int(idx) == i
        check_table(f"batch {i}", t, mask_of(subsets[3 + i]))
    assert frames[5] == "".join(f"p{i}\n" for i in range(CHR8_PATHS))

    req = [st[i + 1] - st[i] for i in range(len(st) - 1)]
    render = [spans.total("render", st[i], st[i + 1]) for i in range(len(req))]
    names = ["depth -d (builds + uploads the index)", "depth -d -s #1 (compiles)",
             "depth -d -s #2", "depth -d -s #3", "depth -S (4 subsets)", "paths"]
    log(f"served: S={n_steps} N={CHR8_SEGS} P={CHR8_PATHS}; all 8 served "
        f"depth tables equal the NumPy reference, and the path list "
        f"matches (reference built in {t_ref:.1f} s)")
    for k in ("synth", "save"):
        log(f"  stage {k:<12} {stage[k]:8.2f} s")
    for k in ("load", "index build", "upload"):
        log(f"  stage {k:<12} {spans.total(k):8.2f} s")
    for name, r, rr in zip(names, req, render):
        log(f"  request {name:<40} {r:8.3f} s  (TSV render {rr:.3f} s, "
            f"rest {r - rr:.3f} s)")
    log(f"  first subset query {req[1] - render[1]:.3f} s, warm subset query "
        f"{statistics.median([req[2] - render[2], req[3] - render[3]]):.3f} s "
        f"(each without TSV render)")
    stats = jax.devices()[0].memory_stats() or {}
    log(f"  device peak bytes in use {stats.get('peak_bytes_in_use', 0) / 2**30:.2f}"
        f" GiB of {stats.get('bytes_limit', 0) / 2**30:.1f} GiB")


def phase_sharded(n_steps: int, cards: int) -> None:
    import jax

    import bench
    from __graft_entry__ import check_sharded
    from pollen_tpu.device import build_device_graph

    devices = jax.devices()[:cards]
    if len(devices) != cards:
        raise SystemExit(f"need {cards} GPUs, found {len(jax.devices())}")
    t0 = time.perf_counter()
    g = bench.synth_graph(n_steps, CHR8_SEGS, CHR8_PATHS, links=True)
    dg = build_device_graph(g, device="host", cross_matrix="always")
    log(f"sharded: S={n_steps} N={CHR8_SEGS} P={CHR8_PATHS}, ingest "
        f"{time.perf_counter() - t0:.1f} s, {cards} cards")
    report, straddles = check_sharded(devices, dg)
    for name, first, warm in report:
        log(f"  {name:<16} first call {first:8.3f} s   warm median "
            f"{warm * 1e3:9.3f} ms   == single-card answer on card 0")
    log(f"  {straddles} (segment, path) groups straddle a chunk boundary")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=10**8,
                    help="step count of the chromosome-scale phase")
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4 runs only the sharded paths over four cards")
    args = ap.parse_args(argv)

    import jax

    from pollen_tpu.device import on_gpu

    if not on_gpu():
        print(f"chip_smoke: no GPU (JAX device {jax.devices()[0].platform!r})",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    phase_device()
    if args.cards == 4:
        phase_sharded(args.steps, 4)
    else:
        phase_fixtures()
        phase_routes()
        phase_served(args.steps)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
