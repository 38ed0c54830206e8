"""Optimizer and gradient compression for the LM scaffold's training (port
of ``repro.optim``)."""
from repro_torch.optim import adamw, compress
