from .config import (
    Config,
    get_mgmt_config,
    get_mgmt_cross_config,
    get_mvitv2_s_config,
    get_swin3d_config,
    modify_config,
    Params,
)

__all__ = [
    "Config",
    "get_mgmt_config",
    "get_mgmt_cross_config",
    "get_mvitv2_s_config",
    "get_swin3d_config",
    "modify_config",
    "Params",
]
