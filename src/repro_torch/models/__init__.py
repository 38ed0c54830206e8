"""Model zoo: unified causal LM over the assigned architecture families
(port of ``repro.models``)."""
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import (CausalLM, backbone, decode_step,
                                   fill_cross_cache, init, init_decode_state,
                                   train_loss)
