"""Element-partitioned runs over several processes (`sharding`)."""

from .sharding import (Partition, gather_field, gather_state, global_sum, init_distributed,
                       make_device_mesh, shard_field, shard_flow_state, shard_sem_mesh)

__all__ = ["Partition", "gather_field", "gather_state", "global_sum", "init_distributed",
           "make_device_mesh", "shard_field", "shard_flow_state", "shard_sem_mesh"]
