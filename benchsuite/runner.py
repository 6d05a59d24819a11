"""Comparison benchmark runner (reference analogue: bench/bench.py).

Runs each (mode, tool, graph) command like hyperfine does — warmup, then
repeated timed runs until max_runs or convergence — and writes a CSV of
mean/stddev wall times. Graphs come from the seeded generator (cached
under ``benchsuite/graphs/``); networked deployments can fetch the real
corpora listed in graphs.toml instead.
"""

from __future__ import annotations

import csv
import pathlib
import statistics
import subprocess
import sys
import time
import tomllib
from typing import Dict, List, Optional

HERE = pathlib.Path(__file__).resolve().parent
GRAPH_DIR = HERE / "graphs"
RESULTS_DIR = HERE / "results"


def load_config() -> Dict:
    with open(HERE / "config.toml", "rb") as f:
        return tomllib.load(f)


def load_graph_book() -> Dict:
    with open(HERE / "graphs.toml", "rb") as f:
        return tomllib.load(f)


def ensure_graph(name: str) -> pathlib.Path:
    """Materialize a corpus graph (generated; cached on disk)."""
    kind, key = name.split(".", 1)
    if kind != "gen":
        raise SystemExit(
            f"corpus {name!r} needs network access; only gen.* graphs are "
            "available here (see graphs.toml)"
        )
    spec = load_graph_book()["gen"][key]
    GRAPH_DIR.mkdir(exist_ok=True)
    path = GRAPH_DIR / f"{key}.gfa"
    if not path.exists():
        sys.path.insert(0, str(HERE.parent / "tests"))
        from graphgen import big_step_graph

        text = big_step_graph(
            spec["segs"], spec["steps"], spec["paths"], seed=42
        )
        path.write_text(text)
    return path


def ensure_gaf(graph_path: pathlib.Path, n_reads: int = 2000) -> None:
    """Generate a read set for a graph (random sub-walks of its paths)."""
    gaf_path = graph_path.with_suffix(".gaf")
    if gaf_path.exists():
        return
    sys.path.insert(0, str(HERE.parent))
    import numpy as np

    from pollen_tpu.flatgfa import parse_gfa_file

    g = parse_gfa_file(str(graph_path))
    rng = np.random.default_rng(17)
    lines = []
    for i in range(n_reads):
        p = int(rng.integers(0, g.num_paths))
        lo, hi = g.path_steps[p]
        if hi - lo < 2:
            continue
        a = int(rng.integers(lo, hi - 1))
        b = int(rng.integers(a + 1, min(a + 40, hi) + 1))
        steps = g.steps[a:b]
        segs = g.seg_name[(steps >> 1).astype(np.int64)]
        revs = (steps & 1).astype(bool)
        path = "".join(
            f"{'<' if r else '>'}{s}" for s, r in zip(segs, revs)
        )
        total = int(g.seg_len[(steps >> 1).astype(np.int64)].sum())
        start = int(rng.integers(0, max(total - 1, 1)))
        end = int(rng.integers(start + 1, total + 1))
        lines.append(
            f"read{i}\t{total}\t0\t{total}\t+\t{path}\t{total}\t{start}"
            f"\t{end}\t1\t1\t60"
        )
    gaf_path.write_text("\n".join(lines) + "\n")


def time_command(
    cmd: str, warmup: int, min_runs: int, max_runs: int
) -> Optional[Dict]:
    """hyperfine-style timing of one shell command."""
    from pollen_tpu.scripts import script_env

    env = script_env()
    # Commands run strictly one after another: each engine process
    # reserves most of a GPU's memory when it first touches the card,
    # so two at once would fail or spoil each other's times.
    for _ in range(warmup):
        r = subprocess.run(
            cmd, shell=True, capture_output=True, text=False, env=env
        )
        if r.returncode != 0:
            print(f"  FAILED: {cmd}\n{r.stderr.decode()[-400:]}", file=sys.stderr)
            return None
    times: List[float] = []
    total = 0.0
    while len(times) < max_runs and (len(times) < min_runs or total < 3.0):
        t0 = time.perf_counter()
        subprocess.run(cmd, shell=True, capture_output=True, env=env)
        dt = time.perf_counter() - t0
        times.append(dt)
        total += dt
    return {
        "mean": statistics.mean(times),
        "stddev": statistics.stdev(times) if len(times) > 1 else 0.0,
        "runs": len(times),
    }


def run(modes: List[str], graph_set: str) -> pathlib.Path:
    config = load_config()
    graphs = config["graph_sets"][graph_set]
    runs_cfg = config["runs"]

    RESULTS_DIR.mkdir(exist_ok=True)
    out_path = RESULTS_DIR / f"{graph_set}-{'-'.join(modes)}.csv"
    rows = []
    for mode in modes:
        tools = config["modes"][mode]
        for graph in graphs:
            path = ensure_graph(graph)
            base = str(path)[: -len(".gfa")]
            if mode == "gaf":
                ensure_gaf(path)
            for tool, template in tools.items():
                cmd = template.format(filename=path, base=base)
                print(f"[{mode}] {tool} on {graph}: {cmd}")
                result = time_command(
                    cmd,
                    runs_cfg["warmup"],
                    runs_cfg["min_runs"],
                    runs_cfg["max_runs"],
                )
                if result is None:
                    continue
                rows.append(
                    {
                        "mode": mode,
                        "graph": graph,
                        "tool": tool,
                        **{k: f"{v:.6f}" if isinstance(v, float) else v
                           for k, v in result.items()},
                    }
                )
                print(
                    f"    {result['mean']*1e3:8.1f} ms "
                    f"± {result['stddev']*1e3:.1f} ({result['runs']} runs)"
                )

    with open(out_path, "w", newline="") as f:
        writer = csv.DictWriter(
            f, fieldnames=["mode", "graph", "tool", "mean", "stddev", "runs"]
        )
        writer.writeheader()
        writer.writerows(rows)
    print(f"wrote {out_path}")
    return out_path
