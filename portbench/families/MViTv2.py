"""MViTv2: the multiscale video transformer with pooling attention
(``models/mvit.py``), whose attention runs in the pooling-attention kernels
(``kernels/pool_attention.py``, K10) and whose pools run in PyTorch's
depthwise convolution kernels."""

from portbench.counts.mvit import forward_flops, pool_attention_calls  # noqa: F401


def model_class():
    from cross_attention_vit_tpu_torch.models.mvit import MViTv2

    return MViTv2


def attention_shape(cfg, batch: int) -> None:
    """The family makes no K1/K2 call."""
    return None


def counters() -> dict[str, int]:
    """The pooling-attention wrappers' launch counters and the pools' calls."""
    from cross_attention_vit_tpu_torch.kernels import pool_attention as pa
    from cross_attention_vit_tpu_torch.ops import pooling_attention as ops

    return {"pool_attention_fwd_calls": pa.pool_attention_fwd.launches,
            "pool_attention_bwd_calls": pa.pool_attention_bwd.launches,
            "mvit_pool_calls": ops.mvit_pool.launches}
