"""nemotron-4-15b [dense] — GQA kv=8, squared-ReLU [arXiv:2402.16819]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b", family="dense", n_layers=32, d_model=6144,
    n_heads=48, n_kv_heads=8, d_ff=24576, vocab=256000, mlp_act="sq_relu")

SMOKE = CONFIG.scaled(n_layers=2, d_model=96, n_heads=6, n_kv_heads=2,
                      d_ff=256, vocab=160)
