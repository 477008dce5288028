"""zamba2-7b [hybrid] — 81L d_model=3584 32H (GQA kv=32) d_ff=14336
vocab=32000, ssm_state=64; Mamba2 backbone with a SHARED attention+MLP block
interleaved every 6 layers [arXiv:2411.15242]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    # 5 mamba blocks then the shared attention block, cycled over 81 layers.
    layer_pattern=("mamba", "mamba", "mamba", "mamba", "mamba", "shared_attn"),
    ssm_state=64,
    ssm_heads=112,          # expand*d_model / 64
    ssm_expand=2,
    source="arXiv:2411.15242",
)
