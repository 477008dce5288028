"""seamless-m4t-medium [audio] — enc-dec multimodal backbone.

12L d_model=1024 16H (GQA kv=16) d_ff=4096 vocab=256206 [arXiv:2308.11596].
The speech frontend (mel-spectrogram + conv feature extractor) is a STUB:
``input_specs()`` provides precomputed frame embeddings (batch, frames, 1024)
consumed by the text/unit decoder's encoder stack.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,            # decoder layers
    n_enc_layers=12,        # encoder layers over frame embeddings
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    n_prefix=1536,          # audio frames fed to the encoder (stubbed embeds)
    rope_theta=10000.0,
    act="gelu",
    source="arXiv:2308.11596",
)
