"""The port's parallel axes.  ``GeometryBatch`` (the dp axis: many
geometries of one functional in lockstep on one card) is the one here;
the JAX package's multi-rank engines (meshes, sharded steps, the
row-sharded sector functions, the distributed set-up) come with the
torch.distributed engines, ROADMAP queue 1 item 8."""

from .sharding import GeometryBatch

__all__ = ["GeometryBatch"]
