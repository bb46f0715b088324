from .routing import default_routing_num_shards, murmur3_32, shard_for_id

__all__ = ["default_routing_num_shards", "murmur3_32", "shard_for_id"]
