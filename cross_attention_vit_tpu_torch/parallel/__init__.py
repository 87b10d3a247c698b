"""Data, expert, sequence, tensor and pipeline parallelism and FSDP over a
``torch.distributed`` process group — port of ``cross_attention_vit_tpu/parallel``
(the 'pipe', 'data', 'expert', 'seq' and 'model' axes)."""

from .mesh import (axis_group, axis_index, axis_mesh, axis_ranks, axis_size, make_mesh,
                   multihost_init, rank, world_size)
from .moe import (MoEFFN, active_expert_mesh, expert_capacity, gather_experts, local_experts,
                  moe_ffn, moe_sites, set_expert_mesh, shard_experts)
from .pipeline import (active_pipeline_mesh, bubble_fraction, pipeline_layers,
                       set_pipeline_mesh, shard_stages, stack_layers, unstack_layers)
from .ring import (active_seq_mesh, ring_attention, ring_sdpa, set_seq_mesh,
                   sharded_ring_sdpa)
from .sharding import (FSDP_MIN_SIZE, Sharding, batch_sharding, fsdp_dim, full_tensor,
                       gather_rows, local_tensors, no_sync, replicated, shard_batch, shard_params,
                       sync_replicated_grads, tp_dim, unwrap, whole_tensors)
from .tensor import TP, gather_tp, local_tp, shard_tensor_parallel

__all__ = ["FSDP_MIN_SIZE", "MoEFFN", "Sharding", "TP", "active_expert_mesh",
           "active_pipeline_mesh", "active_seq_mesh", "axis_group", "axis_index", "axis_mesh",
           "axis_ranks", "axis_size", "batch_sharding", "bubble_fraction", "expert_capacity",
           "fsdp_dim", "full_tensor", "gather_experts", "gather_rows", "gather_tp",
           "local_experts", "local_tensors", "local_tp", "make_mesh", "moe_ffn", "moe_sites",
           "multihost_init", "no_sync", "pipeline_layers", "rank", "replicated",
           "ring_attention", "ring_sdpa", "set_expert_mesh", "set_pipeline_mesh",
           "set_seq_mesh", "shard_batch", "shard_experts", "shard_params", "shard_stages",
           "shard_tensor_parallel", "sharded_ring_sdpa", "stack_layers",
           "sync_replicated_grads", "tp_dim", "unstack_layers", "unwrap", "whole_tensors",
           "world_size"]
