"""hymba-1.5b [hybrid] — parallel attn+mamba heads, GQA kv=5, ssm_state=16,
sliding-window attention (sub-quadratic) [arXiv:2411.13676; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid", n_layers=32, d_model=1600,
    n_heads=25, n_kv_heads=5, d_ff=5504, vocab=32001, mlp_act="swiglu",
    ssm_state=16, ssm_expand=2, window=1024, ssm_chunk=128)

SMOKE = CONFIG.scaled(n_layers=2, d_model=80, n_heads=5, n_kv_heads=5,
                      d_ff=128, vocab=128, window=32, ssm_chunk=16)
