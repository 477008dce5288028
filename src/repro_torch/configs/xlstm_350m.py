"""xlstm-350m [ssm] — 24L d_model=1024 4H (kv=4) d_ff=0 vocab=50304;
mLSTM (matrix memory) blocks with interleaved sLSTM (scalar memory) blocks
at ratio 3:1 [arXiv:2405.04517]. d_ff=0: blocks carry their own up/down
projections (expand factor 2)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    layer_pattern=("mlstm", "mlstm", "mlstm", "slstm"),
    ssm_expand=2,
    ssm_heads=4,
    tie_embeddings=True,
    source="arXiv:2405.04517",
)
