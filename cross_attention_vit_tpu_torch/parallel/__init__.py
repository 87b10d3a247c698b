"""Data parallelism and FSDP over a ``torch.distributed`` process group —
port of ``cross_attention_vit_tpu/parallel`` (the data axis; tensor,
pipeline, sequence and expert parallelism are ROADMAP Queue 1 item 13)."""

from .mesh import make_mesh, multihost_init, rank, world_size
from .sharding import (FSDP_MIN_SIZE, Sharding, batch_sharding, fsdp_dim, full_tensor,
                       gather_rows, no_sync, replicated, shard_batch, shard_params,
                       sync_replicated_grads, unwrap)

__all__ = ["FSDP_MIN_SIZE", "Sharding", "batch_sharding", "fsdp_dim", "full_tensor",
           "gather_rows", "make_mesh", "multihost_init", "no_sync", "rank", "replicated",
           "shard_batch", "shard_params", "sync_replicated_grads", "unwrap", "world_size"]
