"""Node depth two ways: a pure-Python walk over the object API, and
the engine's vectorized kernel path — and a check that they agree.
(Reference analogue: flatgfa-py/examples/depth.py, which only does the
Python walk.)"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))  # run from a bare checkout

import pollen_tpu  # noqa: E402


def depth_by_walking(graph) -> dict:
    """Object-API style: every step crosses the facade one at a time."""
    depths = dict.fromkeys((s.id for s in graph.segments), 0)
    for path in graph.paths:
        for step in path:
            depths[step.seg_id] += 1
    return depths


def main(path: str) -> None:
    graph = pollen_tpu.parse(path)
    walked = depth_by_walking(graph)

    # The same query as one vectorized histogram over the flat arrays.
    from pollen_tpu.device import build_device_graph
    from pollen_tpu.ops.depth import seg_depth_with_uniq

    vectorized, _uniq = seg_depth_with_uniq(build_device_graph(graph.arrays))
    assert all(int(vectorized[i]) == d for i, d in walked.items())

    print("#node.id\tdepth")
    for seg in graph.segments:
        print(f"{seg.name}\t{walked[seg.id]}")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1
         else os.path.join(HERE, "example.gfa"))
