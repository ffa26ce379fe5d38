"""Architecture registry: ``--arch <id>`` lookup for all assigned configs."""

from __future__ import annotations

from typing import Dict

from .base import ArchConfig

from .dbrx_132b import CONFIG as _dbrx
from .deepseek_v2_lite_16b import CONFIG as _dsv2
from .mamba2_2p7b import CONFIG as _mamba2
from .minicpm3_4b import CONFIG as _minicpm3
from .mistral_nemo_12b import CONFIG as _nemo
from .pixtral_12b import CONFIG as _pixtral
from .recurrentgemma_2b import CONFIG as _rg
from .whisper_large_v3 import CONFIG as _whisper
from .yi_34b import CONFIG as _yi34
from .yi_6b import CONFIG as _yi6

ARCHS: Dict[str, ArchConfig] = {
    cfg.arch_id: cfg
    for cfg in [
        _mamba2, _dbrx, _dsv2, _whisper, _pixtral,
        _yi34, _nemo, _yi6, _minicpm3, _rg,
    ]
}


def get_arch(arch_id: str) -> ArchConfig:
    try:
        return ARCHS[arch_id]
    except KeyError:
        raise ValueError(
            f"unknown arch {arch_id!r}; choose from {sorted(ARCHS)}") from None
