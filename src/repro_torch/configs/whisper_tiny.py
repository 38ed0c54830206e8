"""whisper-tiny [audio] — enc-dec, conv frontend STUB (input_specs provides
precomputed frame embeddings) [arXiv:2212.04356; unverified]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="encdec", n_layers=4, d_model=384,
    n_heads=6, n_kv_heads=6, d_ff=1536, vocab=51865, mlp_act="gelu",
    n_enc_layers=4, n_frames=1500)

SMOKE = CONFIG.scaled(n_layers=2, d_model=48, n_heads=3, n_kv_heads=3,
                      d_ff=96, vocab=128, n_enc_layers=2, n_frames=32)
