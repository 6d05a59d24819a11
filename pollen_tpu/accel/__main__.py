"""``exine-tpu``: driver for the fixed-dimension depth accelerator.

Mirrors the reference's ``exine depth`` surface (reference:
pollen_py/pollen/depth/main.py): generate the JSON memories, run the
accelerator, and/or convert outputs to the odgi-style TSV.

    exine-tpu depth -a -r graph.gfa        # end to end, auto dims
    exine-tpu depth --gen graph.gfa        # emit the JSON memories
    exine-tpu json graph.gfa               # generic graph JSON
"""

from __future__ import annotations

import argparse
import sys

from ..flatgfa import parse_gfa_file
from .datagen import (
    accel_dims,
    depth_json,
    depth_table_from_outputs,
    graph_json,
    parse_depth_json,
)
from .kernel import run_accel


def main() -> None:
    parser = argparse.ArgumentParser(prog="exine-tpu")
    sub = parser.add_subparsers(dest="command", metavar="COMMAND")

    cmd = sub.add_parser("depth", help="fixed-dimension depth accelerator")
    cmd.add_argument("graph")
    cmd.add_argument(
        "-a", "--auto", action="store_true", help="auto-size dimensions"
    )
    cmd.add_argument("-n", "--max-nodes", type=int)
    cmd.add_argument("-e", "--max-steps", type=int)
    cmd.add_argument("-p", "--max-paths", type=int)
    cmd.add_argument("-s", "--subset-paths", help="file listing paths")
    cmd.add_argument(
        "--gen",
        action="store_true",
        help="emit the JSON memories instead of running",
    )
    cmd.add_argument(
        "-r",
        "--run",
        action="store_true",
        help="run the accelerator and print the depth table",
    )

    cmd = sub.add_parser("json", help="generic graph JSON")
    cmd.add_argument("graph")

    args = parser.parse_args()
    if not args.command:
        parser.print_help()
        raise SystemExit(1)

    g = parse_gfa_file(args.graph)

    if args.command == "json":
        print(graph_json(g))
        return

    subset = None
    if args.subset_paths:
        with open(args.subset_paths, "r", encoding="utf-8") as f:
            subset = [ln.strip() for ln in f if ln.strip()]

    if args.auto or not (args.max_nodes and args.max_steps and args.max_paths):
        max_n, max_e, max_p = accel_dims(g)
    if args.max_nodes:
        max_n = args.max_nodes
    if args.max_steps:
        max_e = args.max_steps
    if args.max_paths:
        max_p = args.max_paths

    memories = depth_json(g, max_n, max_e, max_p, subset)
    if args.gen:
        print(memories)
        return

    path_ids, consider = parse_depth_json(memories)
    depth, uniq = run_accel(path_ids, consider)
    sys.stdout.write(depth_table_from_outputs(depth, uniq))


if __name__ == "__main__":
    main()
