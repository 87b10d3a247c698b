"""ModelCross: 3 streams of self-attention fused by CLS-query
cross-attention (``models/model_cross.py``)."""

from portbench.counts.flops import model_cross_fwd as forward_flops  # noqa: F401
from portbench.counts.flops import patches
from portbench.families import flash_attention_counters as counters  # noqa: F401


def model_class():
    from cross_attention_vit_tpu_torch.models.model_cross import ModelCross

    return ModelCross


def attention_shape(cfg, batch: int) -> tuple[int, int, int, int]:
    """Self-attention within one stream of num_patches + 1 tokens."""
    k = cfg["num_heads"]
    return batch, k, patches(cfg) + 1, cfg["hidden_dim"] // k
