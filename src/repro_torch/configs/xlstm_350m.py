"""xlstm-350m [ssm] — sLSTM + mLSTM blocks, 4 heads [arXiv:2405.04517]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m", family="ssm", n_layers=24, d_model=1024,
    n_heads=4, n_kv_heads=4, d_ff=0, vocab=50304, ssm_chunk=128)

SMOKE = CONFIG.scaled(n_layers=4, d_model=64, n_heads=2, n_kv_heads=2,
                      vocab=128, ssm_chunk=16)
