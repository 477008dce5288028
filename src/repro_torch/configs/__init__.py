"""Architecture registry: ``--arch <id>`` resolves here."""
from __future__ import annotations

from repro_torch.configs.base import (
    DPPFConfig,
    INPUT_SHAPES,
    InputShape,
    MeshPlan,
    ModelConfig,
    reduced,
)

from repro_torch.configs import (  # noqa: E402
    dbrx_132b,
    gemma2_2b,
    internlm2_20b,
    internvl2_2b,
    llama4_scout_17b_a16e,
    qwen2_72b,
    seamless_m4t_medium,
    xlstm_350m,
    yi_6b,
    zamba2_7b,
)

ARCHS: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (
        seamless_m4t_medium,
        internlm2_20b,
        llama4_scout_17b_a16e,
        dbrx_132b,
        zamba2_7b,
        gemma2_2b,
        internvl2_2b,
        qwen2_72b,
        xlstm_350m,
        yi_6b,
    )
}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> InputShape:
    if name not in INPUT_SHAPES:
        raise KeyError(f"unknown shape {name!r}; available: {sorted(INPUT_SHAPES)}")
    return INPUT_SHAPES[name]


__all__ = [
    "ARCHS",
    "DPPFConfig",
    "INPUT_SHAPES",
    "InputShape",
    "MeshPlan",
    "ModelConfig",
    "get_arch",
    "get_shape",
    "reduced",
]
