"""Data, expert and sequence parallelism and FSDP over a ``torch.distributed``
process group — port of ``cross_attention_vit_tpu/parallel`` (the 'data',
'expert' and 'seq' axes; tensor and pipeline parallelism are ROADMAP Queue 1
item 13)."""

from .mesh import (axis_group, axis_index, axis_mesh, axis_size, make_mesh, multihost_init,
                   rank, world_size)
from .moe import (MoEFFN, active_expert_mesh, expert_capacity, gather_experts, local_experts,
                  moe_ffn, moe_sites, set_expert_mesh, shard_experts)
from .ring import (active_seq_mesh, ring_attention, ring_sdpa, set_seq_mesh,
                   sharded_ring_sdpa)
from .sharding import (FSDP_MIN_SIZE, Sharding, batch_sharding, fsdp_dim, full_tensor,
                       gather_rows, no_sync, replicated, shard_batch, shard_params,
                       sync_replicated_grads, unwrap)

__all__ = ["FSDP_MIN_SIZE", "MoEFFN", "Sharding", "active_expert_mesh", "active_seq_mesh",
           "axis_group", "axis_index", "axis_mesh", "axis_size", "batch_sharding",
           "expert_capacity", "fsdp_dim", "full_tensor", "gather_experts", "gather_rows",
           "local_experts", "make_mesh", "moe_ffn", "moe_sites", "multihost_init", "no_sync",
           "rank", "replicated", "ring_attention", "ring_sdpa", "set_expert_mesh",
           "set_seq_mesh", "shard_batch", "shard_experts", "shard_params", "sharded_ring_sdpa",
           "sync_replicated_grads", "unwrap", "world_size"]
