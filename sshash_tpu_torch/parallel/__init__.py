"""The bucket-sharded engine on a mesh of shards (the counterpart of
sshash_tpu.parallel): mesh.LocalMesh / mesh.DistMesh and their combines,
sharded.ShardedEngine / ShardedStream, and the torch.distributed helpers
of multihost."""

from . import multihost
from .mesh import DistMesh, LocalMesh
from .sharded import ShardedEngine, ShardedStream, shard_tables

__all__ = ["DistMesh", "LocalMesh", "ShardedEngine", "ShardedStream", "multihost",
           "shard_tables"]
