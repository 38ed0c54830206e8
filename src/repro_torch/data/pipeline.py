"""Deterministic synthetic token pipeline with a checkpointable cursor
(port of ``repro.data.pipeline``; the port keeps its own copy).

The stream is a pure function of (seed, step): ``np.random.default_rng(
(seed, step))`` and a fixed random bigram table drawn from the seed, so a
resume is a replay from the cursor and no shuffle-buffer state needs
snapshotting, and a batch is bit for bit the reference's. Batches are made
on the host as numpy and moved to a device by :func:`to_device`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0


class TokenPipeline:
    """Markov-ish synthetic LM stream (it has learnable structure, so the
    loss decreases under training)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.step = 0
        rng = np.random.default_rng(cfg.seed)
        # fixed random bigram table => learnable next-token structure
        k = min(cfg.vocab, 64)
        self._trans = rng.integers(0, cfg.vocab, size=(cfg.vocab, k))

    def state(self) -> Dict:
        return {"step": self.step, "seed": self.cfg.seed}

    def restore(self, state: Dict):
        if state["seed"] != self.cfg.seed:
            raise ValueError(f"data seed changed mid-run: the cursor was "
                             f"saved with {state['seed']}, this pipeline "
                             f"has {self.cfg.seed}")
        self.step = int(state["step"])

    def next_batch(self) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, self.step))
        B, S = cfg.global_batch, cfg.seq_len
        toks = np.empty((B, S), np.int32)
        toks[:, 0] = rng.integers(0, cfg.vocab, B)
        choice = rng.integers(0, self._trans.shape[1], (B, S))
        for t in range(1, S):
            toks[:, t] = self._trans[toks[:, t - 1], choice[:, t]]
        self.step += 1
        labels = np.roll(toks, -1, axis=1)
        labels[:, -1] = toks[:, 0]
        return {"tokens": toks, "labels": labels}

    def iter(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()


def to_device(batch: Dict[str, np.ndarray], device=None):
    """The batch's arrays as tensors on ``device`` (None = the card; it
    raises without one), dtypes kept (tokens stay int32)."""
    import torch
    from repro_torch.core.saif import resolve_device
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in batch.items()}
