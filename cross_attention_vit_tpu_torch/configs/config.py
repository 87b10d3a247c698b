"""Config system.

Mirrors the reference's two `ml_collections.ConfigDict` factories and the
`modify_config` overlay-merge (reference: config.py:3-36, config2.py:3-35),
including namedtuple support, but as a plain attribute-dict so the framework
has no ml_collections dependency.  This is the PyTorch port's own copy of
``cross_attention_vit_tpu/configs/config.py`` (same presets, field for field),
so the port never imports the JAX package.
"""

from __future__ import annotations

import copy
from collections import namedtuple
from typing import Any, Mapping


class Config:
    """Attribute-style mutable config (ConfigDict-lite).

    Supports ``cfg.key``, ``cfg['key']``, ``in``, ``.get``, ``.keys``,
    ``.to_dict``, ``del cfg.key`` and a deep ``.copy()``.  Unknown attribute
    reads raise AttributeError just like ml_collections.
    """

    def __init__(self, **kwargs: Any) -> None:
        self.__dict__["_fields"] = dict(kwargs)

    # -- attribute protocol -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self.__dict__["_fields"][name]
        except KeyError:
            raise AttributeError(f"Config has no field {name!r}") from None

    def __setattr__(self, name: str, value: Any) -> None:
        self.__dict__["_fields"][name] = value

    def __delattr__(self, name: str) -> None:
        del self.__dict__["_fields"][name]

    # -- mapping protocol ----------------------------------------------------
    def __getitem__(self, name: str) -> Any:
        return self.__dict__["_fields"][name]

    def __setitem__(self, name: str, value: Any) -> None:
        self.__dict__["_fields"][name] = value

    def __contains__(self, name: str) -> bool:
        return name in self.__dict__["_fields"]

    def get(self, name: str, default: Any = None) -> Any:
        return self.__dict__["_fields"].get(name, default)

    def keys(self):
        return self.__dict__["_fields"].keys()

    def to_dict(self) -> dict:
        return dict(self.__dict__["_fields"])

    def copy(self) -> "Config":
        return Config(**copy.deepcopy(self.__dict__["_fields"]))

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        body = ", ".join(f"{k}={v!r}" for k, v in self.__dict__["_fields"].items())
        return f"Config({body})"

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Config) and other.to_dict() == self.to_dict()


# Hyperparameter-grid entry, mirroring main_mist.py:59.  `attn_order` keys must
# be strings (reference keeps them str for ConfigDict compatibility,
# main_mist.py:70); we keep the convention for drop-in parity.
Params = namedtuple(
    "Params",
    [
        "lr",
        "dropout",
        "attn_order",
        "optim_params",
        "weight_decay",
        "img_types",
        "label_smoothing",
        "img_aug",
    ],
)


def _base_mgmt_config() -> Config:
    """Fields shared by both presets (reference config.py:4-27, config2.py:4-26)."""
    return Config(
        hidden_dim=1024,
        mlp_dim=4096,
        num_heads=16,
        patch_size=(16, 16, 8),
        # CNN-stem keys (consumed by the legacy CNN/ViT family; reference
        # config.py:16-19 carries them unused by the live models).
        conv_first_channel=512,
        encoder_channels=(16, 32, 64),
        down_factor=2,
        down_num=2,
        num_classes=2,
        img_size=(128, 128, 64),
        in_channels=1,
        spacing=(2, 2, 2),
        target="MGMT status",
        # Framework-level knobs (no reference counterpart): compute dtype for
        # matmuls (bfloat16 on the serving path; float32 for parity tests)
        # and whether self-attention runs the hand-written fused kernel.
        compute_dtype="float32",
        use_flash_attention=False,
    )


def get_mgmt_config() -> Config:
    """Single-stream ViT preset (reference config.py:3-29)."""
    cfg = _base_mgmt_config()
    cfg.num_layers = 4
    return cfg


def get_mgmt_cross_config() -> Config:
    """Cross-attention preset (reference config2.py:3-28)."""
    cfg = _base_mgmt_config()
    cfg.num_multi_blocks = 2
    cfg.num_self_blocks = 2
    return cfg


def get_swin3d_config() -> Config:
    """Swin UNETR's 3-D Swin encoder at its BraTS setting (Hatamizadeh et
    al., arXiv:2201.01266; MONAI ``SwinUNETR(feature_size=48)``) with a
    classification head (``models/swin3d.py``): four MRI channels (T1, T1c,
    T2, FLAIR) at 128³, a 2³ patch embedding to 48 channels, four stages of
    2 blocks at widths 48-384 with 3-24 heads of 16, 7³ windows shifted by
    3 in every second block, MLP ratio 4 with erf GELU, and Adam at lr 1e-4
    with weight decay 1e-5 (the paper's recipe; the port's Adam adds L2
    decay).  Dropout, attention dropout and drop path are 0, as in MONAI's
    BraTS recipe."""
    return Config(
        img_size=(128, 128, 128),
        in_channels=1,
        num_modalities=4,
        img_types=("T1", "T1c", "T2", "FLAIR"),
        patch_size=(2, 2, 2),
        feature_size=48,
        depths=(2, 2, 2, 2),
        swin_heads=(3, 6, 12, 24),
        window_size=(7, 7, 7),
        mlp_ratio=4,
        num_classes=2,
        target="MGMT status",
        spacing=(2, 2, 2),
        compute_dtype="float32",
        use_flash_attention=False,
        gelu_approx=False,
        dropout=0.0,
        lr=1e-4,
        weight_decay=1e-5,
        optim_params={"T_max": 250, "eta_min": 1e-6},
        label_smoothing=0.0,
        img_aug=True,
    )


def get_mvitv2_s_config() -> Config:
    """MViTv2-S for Kinetics-400 (Li et al., arXiv:2112.01526; PySlowFast
    ``configs/Kinetics/MViTv2_S_16x4.yaml``) as ``models/mvit.py`` computes
    it: 16 × 224² RGB clips (the three planes as the stem's channels), a
    (3, 7, 7) stem of stride (2, 4, 4) to 96 channels, 16 blocks whose width
    and heads double at blocks 1, 3 and 14 (96/1 to 768/8, heads of 96),
    query stride (1, 2, 2) there, key/value stride (1, 8, 8) divided at each
    transition, 3³ depthwise pools, MLP ratio 4 with erf GELU, drop path to
    0.2, head dropout 0.5, LayerNorm eps 1e-6, and the port's Adam at lr
    1e-4 with weight decay 1e-5 (the recipe's AdamW is not the port's).
    Products, convolutions and activations in bf16, as the benchmark's
    ``mvitv2_s.k400`` configuration trains it.  No option picks the
    attention: K10 on the card, its plain versions on the CPU."""
    return Config(
        img_size=(16, 224, 224),
        in_channels=1,
        num_modalities=3,
        patch_kernel=(3, 7, 7),
        patch_stride=(2, 4, 4),
        patch_padding=(1, 3, 3),
        embed_dim=96,
        num_heads=1,
        depth=16,
        dim_mul_blocks=(1, 3, 14),
        pool_q_stride=(1, 2, 2),
        pool_kv_stride_adaptive=(1, 8, 8),
        mlp_ratio=4,
        drop_path_rate=0.2,
        dropout=0.5,
        layer_norm_eps=1e-6,
        num_classes=400,
        compute_dtype="bfloat16",
        activation_dtype="bfloat16",
        augment_dtype="bfloat16",
        gelu_approx=False,
        lr=1e-4,
        weight_decay=1e-5,
        optim_params={"T_max": 250, "eta_min": 1e-6},
        label_smoothing=0.0,
        img_aug=False,
    )


def modify_config(config: Config, params: Any) -> Config:
    """Overlay `params` onto `config` in place and return it.

    Accepts a Mapping or any namedtuple-like object exposing ``_asdict``
    (reference config.py:31-36 semantics, including in-place mutation).
    """
    if not isinstance(params, Mapping):
        params = params._asdict()
    for key, value in params.items():
        setattr(config, key, value)
    return config
