"""Sharding of a dispatch over a mesh of devices (`mesh.py`): the port of
`bitcoinconsensus_tpu/parallel/`."""

from .mesh import Mesh, ShardedSecpVerifier, make_mesh, make_sharded_step

__all__ = ["Mesh", "ShardedSecpVerifier", "make_mesh", "make_sharded_step"]
