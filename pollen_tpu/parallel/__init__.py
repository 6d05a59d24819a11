"""Multi-device execution: meshes, sharded graph tensors, collective
reductions (reference analogue: none — the reference is a
single-process system; this layer is the scaling story described in
SURVEY.md §5/§7)."""

from .sharded import (  # noqa: F401
    ShardedGraph,
    make_mesh,
    shard_device_graph,
    sharded_seg_depth_fn,
)
