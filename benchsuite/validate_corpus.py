"""Real-corpus validation: fetch an HPRC/1000G pangenome, exact-diff
depth/degree against the oracle, and measure single-chip steps/s.

One command for the first networked deployment (this build environment
has no egress, so the fetch path is exercised here only via
``--graph`` substitution with a local fixture — the dry-run test):

    python -m benchsuite.validate_corpus hprc.chr8

Steps (reference analogue: bench/bench.py:89-108 fetch + the turnt
exact-diff envs of tests/turnt.toml):

1. fetch the graph named in graphs.toml ([hprc]/[1000gont] URL books),
   decompressing .gz/.zst on download, cached under benchsuite/graphs/;
2. convert GFA -> FlatGFA (fgfa-tpu -I ... -o ...) and byte-round-trip
   the text through the engine;
3. exact-diff `depth -d` and `degree -d` between the engine and the
   executable spec (pollen-spec == slow_odgi semantics; pass --odgi to
   diff against a real odgi binary instead);
4. measure masked-depth steps/s on the default device via bench.py's
   chained-timing harness over the ingested graph.
"""

from __future__ import annotations

import argparse
import gzip
import pathlib
import shutil
import subprocess
import sys
import time
import urllib.request

HERE = pathlib.Path(__file__).resolve().parent
GRAPH_DIR = HERE / "graphs"


def corpus_url(name: str) -> str:
    import tomllib

    with open(HERE / "graphs.toml", "rb") as f:
        book = tomllib.load(f)
    kind, chrom = name.split(".", 1)
    table = book[kind]
    if chrom not in table["chroms"]:
        raise SystemExit(
            f"{name}: unknown chrom {chrom!r} (book has {table['chroms']})"
        )
    return table["url_template"].format(chrom=chrom)


def fetch(name: str) -> pathlib.Path:
    """Download + decompress a corpus graph (cached)."""
    GRAPH_DIR.mkdir(exist_ok=True)
    out = GRAPH_DIR / f"{name}.gfa"
    if out.exists():
        print(f"# cached {out}")
        return out
    url = corpus_url(name)
    print(f"# fetching {url}")
    tmp = out.with_suffix(".part")
    with urllib.request.urlopen(url, timeout=60) as res, open(
        tmp, "wb"
    ) as f:
        if url.endswith(".gz"):
            with gzip.open(res) as gz:
                shutil.copyfileobj(gz, f, length=1 << 20)
        elif url.endswith(".zst"):
            try:
                import zstandard
            except ImportError:
                raise SystemExit(
                    "zstandard not installed; fetch and decompress "
                    f"{url} manually to {out}"
                )
            zstandard.ZstdDecompressor().copy_stream(res, f)
        else:
            shutil.copyfileobj(res, f, length=1 << 20)
    tmp.rename(out)
    return out


def run(cmd: list[str]) -> str:
    print("#", " ".join(cmd))
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        sys.stderr.write(res.stderr)
        raise SystemExit(f"command failed: {' '.join(cmd)}")
    return res.stdout


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("corpus", help="graphs.toml name, e.g. hprc.chr8")
    ap.add_argument(
        "--graph",
        help="skip the fetch; validate this local GFA instead "
        "(dry-run/testing)",
    )
    ap.add_argument(
        "--odgi",
        help="path to an odgi binary to use as the oracle "
        "(default: the executable spec, pollen-spec)",
    )
    ap.add_argument(
        "--skip-bench",
        action="store_true",
        help="skip the steps/s measurement (diff parity only)",
    )
    args = ap.parse_args(argv)

    gfa = pathlib.Path(args.graph) if args.graph else fetch(args.corpus)
    print(f"# graph {gfa} ({gfa.stat().st_size / 1e6:.1f} MB)")

    # 1. Conversion + byte round trip.
    flat = gfa.with_suffix(".flatgfa")
    run(["fgfa-tpu", "-I", str(gfa), "-o", str(flat)])
    rt = run(["fgfa-tpu", "-i", str(flat)])
    if rt != gfa.read_text():
        raise SystemExit("FAIL: GFA -> FlatGFA -> GFA is not byte-identical")
    print("# round trip: byte-identical OK")

    # 2. Exact-diff depth/degree vs the oracle.
    for query, flags in (("depth", ["-d"]), ("degree", [])):
        engine = run(["fgfa-tpu", "-i", str(flat), query, *flags])
        if args.odgi:
            oracle = run([args.odgi, query, "-i", str(gfa), "-d"])
        else:
            oracle = run(["pollen-spec", query, str(gfa)])
        if engine != oracle:
            raise SystemExit(f"FAIL: {query} differs from the oracle")
        print(f"# {query}: exact-diff OK ({len(engine.splitlines())} lines)")

    if args.skip_bench:
        print("VALIDATION OK (bench skipped)")
        return

    # 3. Single-device steps/s on the ingested graph (bench.py's
    # block_until_ready timing on the index the router picks).
    sys.path.insert(0, str(HERE.parent))
    import bench as bench_mod

    from pollen_tpu.flatgfa import parse_gfa_file
    from pollen_tpu.ops.depth import _best_masked_impl

    t0 = time.perf_counter()
    g = parse_gfa_file(str(gfa))
    from pollen_tpu.device import build_device_graph

    dg_host = build_device_graph(g, minimal=True, device="host")
    impl = _best_masked_impl(dg_host)
    dg = bench_mod.project_for_impl(dg_host, impl)
    print(
        f"# ingest {time.perf_counter() - t0:.1f}s, impl {impl}, "
        f"S={g.num_steps}"
    )
    per_query = bench_mod.measure_depth(dg, reps=20, impl=impl)
    print(
        f"RESULT {args.corpus}: {g.num_steps / per_query / 1e9:.2f} G "
        f"steps/s ({per_query * 1e6:.1f} us/query, impl {impl})"
    )
    print("VALIDATION OK")


if __name__ == "__main__":
    main()
