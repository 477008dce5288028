"""internvl2-2b [vlm] — InternViT + InternLM2-1.8B backbone: 24L d_model=2048
16H (GQA kv=8) d_ff=8192 vocab=92553 [arXiv:2404.16821].
The InternViT vision encoder + MLP projector are a STUB: ``input_specs()``
provides precomputed patch embeddings (batch, n_patches, 2048) prepended to
the token sequence (early fusion)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=92553,
    n_prefix=256,           # ViT patch embeddings per image (stubbed)
    rope_theta=1000000.0,
    source="arXiv:2404.16821",
)
