"""llama-3.2-vision-11b [vlm] — cross-attn image layers every 5, vision
tower STUB (input_specs provides patch embeddings)
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm", n_layers=40, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab=128256, mlp_act="swiglu",
    cross_every=5, n_image_tokens=1024)

SMOKE = CONFIG.scaled(n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
                      d_ff=160, vocab=128, cross_every=2, n_image_tokens=16)
