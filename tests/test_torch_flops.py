"""The port's FLOP counter (``cross_attention_vit_tpu_torch/utils/flops.py``)
against the JAX package's ``utils/flops.py``: the same integer counts for
the three live configurations (the experiment grid's ModelCross, ModelVIT on
2 and on 3 streams, each as the CLI builds it: the grid point, then
``num_modalities`` from its image types) and two small ones; ``mfu``'s
arithmetic against the card's peak; a card without a known peak raises."""

import pytest

from cross_attention_vit_tpu.configs import get_mgmt_config as jax_vit_config
from cross_attention_vit_tpu.configs import get_mgmt_cross_config as jax_cross_config
from cross_attention_vit_tpu.configs import modify_config as jax_modify
from cross_attention_vit_tpu.drivers import experiments as jexp
from cross_attention_vit_tpu.utils import flops as jflops
from cross_attention_vit_tpu_torch.configs import (get_mgmt_config, get_mgmt_cross_config,
                                                   modify_config)
from cross_attention_vit_tpu_torch.drivers import experiments as texp
from cross_attention_vit_tpu_torch.utils import flops as tflops

SMALL = dict(hidden_dim=32, mlp_dim=64, num_heads=4, num_multi_blocks=1, num_self_blocks=2,
             num_layers=2, img_size=(16, 16, 8), patch_size=(8, 8, 8), num_modalities=2,
             attn_order={"0": "1", "1": "0"})
# name: (family, fields over the preset, or the grid point (list, index) and its streams)
CONFIGS = {
    "live_cross": ("cross", ("params_list1", 0, 3)),
    "live_vit_2_streams": ("vit", ("params_list2", 1, 2)),
    "live_vit_3_streams": ("vit", ("params_list2", 1, 3)),
    "small_cross": ("cross", SMALL),
    "small_vit": ("vit", {**SMALL, "num_modalities": 3, "hidden_dim": 48}),
}


def _configs(name: str):
    family, spec = CONFIGS[name]
    pair = ((jax_cross_config(), get_mgmt_cross_config()) if family == "cross"
            else (jax_vit_config(), get_mgmt_config()))
    for cfg, modify, grids in zip(pair, (jax_modify, modify_config), (jexp, texp)):
        if isinstance(spec, tuple):
            grid, index, streams = spec
            modify(cfg, getattr(grids, grid)[index])
            modify(cfg, {"num_modalities": streams})
        else:
            modify(cfg, spec)
    return family, pair


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_flop_counts_equal_jax(name, batch):
    family, (jc, tc) = _configs(name)
    fwd = {"cross": (jflops.model_cross_fwd_flops, tflops.model_cross_fwd_flops),
           "vit": (jflops.model_vit_fwd_flops, tflops.model_vit_fwd_flops)}[family]
    want, got = fwd[0](jc, batch), fwd[1](tc, batch)
    assert type(got) is int and got == want > 0
    assert tflops.train_flops(got) == jflops.train_flops(want) == 3 * got


def test_mfu_is_achieved_over_the_h100_peak():
    peak = tflops.chip_peak_bf16_flops("NVIDIA H100 80GB HBM3")
    assert peak == 989.4e12
    assert tflops.chip_peak_bf16_flops("NVIDIA H100 SXM5 80GB") == peak
    assert tflops.mfu(int(989.4e12), 2.0, "NVIDIA H100 80GB HBM3") == pytest.approx(0.5)
    assert tflops.mfu(10 ** 12, 0.5, "NVIDIA H100 80GB HBM3") == 2e12 / 989.4e12


@pytest.mark.parametrize("device_name", ["NVIDIA H100 PCIe", "NVIDIA A100-SXM4-80GB", "TPU v5e"])
def test_unknown_card_raises(device_name):
    """No silent fallback to another part's peak (JAX falls back to v5e)."""
    with pytest.raises(ValueError, match="no bf16 peak known"):
        tflops.chip_peak_bf16_flops(device_name)
    with pytest.raises(ValueError, match="no bf16 peak known"):
        tflops.mfu(10 ** 12, 1.0, device_name)
