"""The frozen counts against the hand figures and against the port's own
FLOP counter, at both configurations."""

import json
from pathlib import Path

import pytest

from portbench import harness
from portbench.counts import attention, flops, peaks

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def _cfg(name: str) -> tuple[object, dict]:
    """The configuration's family (its program-side file) and fields."""
    conf = json.loads((CONFIGS / f"{name}.json").read_text())
    return harness.family(conf["family"]).program, conf["config"]


@pytest.mark.parametrize("name, gflop", [("model_cross.live", 187.37),
                                         ("model_vit.live2", 124.70)])
def test_forward_gflop_per_sample_equals_the_hand_figure(name, gflop):
    family, cfg = _cfg(name)
    assert family.forward_flops(cfg, 1) / 1e9 == pytest.approx(gflop, abs=0.005)


@pytest.mark.parametrize("name, tflop", [("model_cross.live", 35.98),
                                         ("model_vit.live2", 23.94)])
def test_train_step_at_batch_64_is_three_forwards(name, tflop):
    family, cfg = _cfg(name)
    step = flops.train_step(family.forward_flops(cfg, 64))
    assert step == 3 * family.forward_flops(cfg, 64)
    assert step / 1e12 == pytest.approx(tflop, abs=0.005)


@pytest.mark.parametrize("name", ["model_cross.live", "model_vit.live2"])
def test_counts_equal_the_ports_flop_counter(name):
    from cross_attention_vit_tpu_torch.configs import Config
    from cross_attention_vit_tpu_torch.utils import flops as port_flops

    family, cfg = _cfg(name)
    port_cfg = Config(**{k: tuple(v) if isinstance(v, list) else v for k, v in cfg.items()})
    port = {"model_cross.live": port_flops.model_cross_fwd_flops,
            "model_vit.live2": port_flops.model_vit_fwd_flops}[name]
    for batch in (1, 16, 64):
        assert family.forward_flops(cfg, batch) == port(port_cfg, batch)
        assert flops.train_step(family.forward_flops(cfg, batch)) == port_flops.train_flops(
            port(port_cfg, batch))
    assert peaks.card_peaks("NVIDIA H100 80GB HBM3")[0] == port_flops.chip_peak_bf16_flops(
        "NVIDIA H100 80GB HBM3")


@pytest.mark.parametrize("name, shape", [("model_cross.live", (64, 16, 513, 64)),
                                         ("model_vit.live2", (64, 16, 1025, 64))])
def test_attention_shape_of_the_cells(name, shape):
    family, cfg = _cfg(name)
    assert family.attention_shape(cfg, 64) == shape


def test_k1_at_the_cross_cell_is_bound_by_bytes():
    B, K, N, D = 64, 16, 513, 64
    assert attention.k1_bytes(B, K, N, D) == 4 * B * N * K * D * 2
    assert attention.k1_flops(B, K, N, D) == 4 * B * K * N * N * D
    seconds, bound = attention.least_seconds(attention.k1_flops(B, K, N, D),
                                             attention.k1_bytes(B, K, N, D),
                                             peaks.BF16_FLOPS, peaks.HBM_BYTES_S)
    assert bound == "bytes"
    assert seconds == pytest.approx(attention.k1_bytes(B, K, N, D) / 3.35e12)


def test_k2_at_the_cross_cell_is_bound_by_operations():
    B, K, N, D = 64, 16, 513, 64
    seconds, bound = attention.least_seconds(attention.k2_flops(B, K, N, D),
                                             attention.k2_bytes(B, K, N, D),
                                             peaks.BF16_FLOPS, peaks.HBM_BYTES_S)
    assert bound == "operations"
    assert seconds == pytest.approx(10 * B * K * N * N * D / 989.4e12)


@pytest.mark.parametrize("card", ["NVIDIA H100 PCIe", "NVIDIA A100-SXM4-80GB", "cpu"])
def test_a_card_without_a_published_peak_raises(card):
    with pytest.raises(ValueError):
        peaks.card_peaks(card)
