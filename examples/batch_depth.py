"""Batched subset-depth serving with the engine API: one resident
graph, many path-subset queries answered in a single device pass (the
shape production serving wants; the reference answers one query per
fgfa invocation — no equivalent exists there)."""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))  # run from a bare checkout


def main(path: str) -> None:
    import numpy as np

    from pollen_tpu.device import build_device_graph
    from pollen_tpu.flatgfa import parse_gfa_file
    from pollen_tpu.ops.depth import (
        path_mask_for,
        seg_depth_with_uniq_batch,
    )

    g = parse_gfa_file(path)
    # ell_objective="batch" plans the resident index for batched
    # throughput.
    dg = build_device_graph(g, ell_objective="batch")

    names = [g.path_name_bytes(i).decode() for i in range(g.num_paths)]
    subsets = [names[:1], names, names[::2]]
    masks = np.stack([path_mask_for(g, s) for s in subsets])

    depth, uniq = seg_depth_with_uniq_batch(dg, masks)
    for q, subset in enumerate(subsets):
        print(f"# subset {q}: {','.join(subset)}")
        print("#node.id\tdepth\tdepth.uniq")
        for i in range(g.num_segments):
            print(f"{g.seg_name[i]}\t{depth[q][i]}\t{uniq[q][i]}")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else
         os.path.join(HERE, "example.gfa"))
