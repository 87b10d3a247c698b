"""ModelVIT: one transformer over every stream's tokens behind one CLS
token (``models/model_vit.py``)."""

from portbench.counts.flops import model_vit_fwd as forward_flops  # noqa: F401
from portbench.counts.flops import patches
from portbench.families import flash_attention_counters as counters  # noqa: F401


def model_class():
    from cross_attention_vit_tpu_torch.models.model_vit import ModelVIT

    return ModelVIT


def attention_shape(cfg, batch: int) -> tuple[int, int, int, int]:
    """Self-attention over every stream's patches and the CLS token."""
    k = cfg["num_heads"]
    return batch, k, patches(cfg) * cfg["num_modalities"] + 1, cfg["hidden_dim"] // k
