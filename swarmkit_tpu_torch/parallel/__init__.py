"""The node-axis split of the scheduling kernels (``parallel/sharded.py``)."""

from .sharded import (  # noqa: F401
    NODE_AXIS, NodeMesh, ShardedPlanFn, make_mesh,
)
