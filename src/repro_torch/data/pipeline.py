"""Deterministic-resume sharded data pipeline.

A numpy copy of the JAX package's ``data/pipeline.py`` (the tests pin
``batch_at`` and ``host_slice`` bitwise against it).

Fault-tolerance contract (the training-loop half of the paper's re-execution
story): a batch is a **pure function of (seed, step)** — no iterator state —
so a job restarted from a step-N checkpoint consumes exactly the batches it
would have seen without the failure.  Elastic scaling follows for free: the
global batch is assembled identically regardless of worker count, and each
worker slices its shard by mesh position.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from repro_torch.data.packing import TokenShards


@dataclasses.dataclass
class PipelineConfig:
    global_batch: int
    seq_len: int
    seed: int = 0


class TokenPipeline:
    """Samples fixed (B, S+1) windows from packed shards, step-indexed."""

    def __init__(self, shards: TokenShards, cfg: PipelineConfig):
        if shards.n_shards == 0:
            raise ValueError("empty shard set")
        self.shards = shards
        self.cfg = cfg
        self._flat = shards.tokens.reshape(-1)
        self._limit = len(self._flat) - (cfg.seq_len + 1)
        if self._limit <= 0:
            raise ValueError("corpus smaller than one sequence")

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Global batch for ``step`` (deterministic, restart-safe)."""
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, int(step)])
        )
        starts = rng.integers(0, self._limit, size=cfg.global_batch)
        idx = starts[:, None] + np.arange(cfg.seq_len + 1)[None, :]
        window = self._flat[idx]
        return {
            "tokens": window[:, :-1].astype(np.int32),
            "labels": window[:, 1:].astype(np.int32),
        }

    def host_slice(
        self, batch: Dict[str, np.ndarray], host_id: int, n_hosts: int
    ) -> Dict[str, np.ndarray]:
        """Per-host slice of the global batch (multi-host loading)."""
        b = self.cfg.global_batch
        per = b // n_hosts
        sl = slice(host_id * per, (host_id + 1) * per)
        return {k: v[sl] for k, v in batch.items()}
