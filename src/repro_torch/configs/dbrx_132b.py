"""dbrx-132b [moe] — 16 experts top-4, fine-grained
[hf:databricks/dbrx-base; unverified]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b", family="moe", n_layers=40, d_model=6144,
    n_heads=48, n_kv_heads=8, d_ff=10752, vocab=100352, mlp_act="swiglu",
    n_experts=16, top_k=4)

SMOKE = CONFIG.scaled(n_layers=2, d_model=96, n_heads=6, n_kv_heads=2,
                      d_ff=64, vocab=128, n_experts=4, top_k=2)
