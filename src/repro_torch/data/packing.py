"""Token-stream packing: the paper's sequence-file idea applied to LM data.

A numpy copy of the JAX package's ``data/packing.py``: that module imports
no JAX, but the port imports nothing of the JAX package.  The tests pin
its outputs bitwise against the original.

The coaddition pipeline went fast when many small files became few large,
indexed, *structured* containers (paper §4.1.2-4.1.3).  The training data
pipeline applies the same recipe to documents:

  * documents (variable-length "small files") are packed back-to-back into
    fixed-length **token shards** (large containers; static shapes for TPU);
  * shards are *structured* by source/domain key so a run can prune shards
    by metadata before dispatch (the glob prefilter analogue — e.g. train on
    a domain subset without touching the rest of the corpus);
  * a shard index maps document id -> (shard, offset) (the SQL analogue).

Packing emits boundary-crossing documents contiguously (GPT-style) with
document ids carried alongside for masking experiments.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class TokenShards:
    tokens: np.ndarray        # (n_shards, shard_len) int32
    doc_ids: np.ndarray       # (n_shards, shard_len) int32
    source_key: np.ndarray    # (n_shards,) int32 — structured container key
    index: Dict[int, Tuple[int, int]]  # doc -> (shard, offset)

    @property
    def n_shards(self) -> int:
        return self.tokens.shape[0]

    def prune(self, keys: Sequence[int]) -> "TokenShards":
        """Structured-container pruning: keep only shards from given sources."""
        mask = np.isin(self.source_key, np.asarray(list(keys)))
        sel = np.nonzero(mask)[0]
        remap = {int(s): i for i, s in enumerate(sel)}
        index = {
            d: (remap[p], o) for d, (p, o) in self.index.items() if p in remap
        }
        return TokenShards(
            self.tokens[sel], self.doc_ids[sel], self.source_key[sel], index
        )


def pack_documents(
    docs: List[np.ndarray],
    doc_sources: Optional[Sequence[int]],
    shard_len: int,
    structured: bool = True,
) -> TokenShards:
    """Pack variable-length docs into fixed shards, grouped by source."""
    n = len(docs)
    sources = list(doc_sources) if doc_sources is not None else [0] * n
    order = sorted(range(n), key=lambda i: sources[i]) if structured else list(range(n))

    shards: List[np.ndarray] = []
    dids: List[np.ndarray] = []
    skeys: List[int] = []
    index: Dict[int, Tuple[int, int]] = {}

    cur = np.zeros((shard_len,), np.int32)
    cur_did = np.full((shard_len,), -1, np.int32)
    fill = 0
    cur_key = sources[order[0]] if order else 0

    def flush():
        nonlocal cur, cur_did, fill
        if fill == 0:
            return
        shards.append(cur.copy())
        dids.append(cur_did.copy())
        skeys.append(cur_key)
        cur = np.zeros((shard_len,), np.int32)
        cur_did = np.full((shard_len,), -1, np.int32)
        fill = 0

    for i in order:
        if structured and sources[i] != cur_key:
            flush()
            cur_key = sources[i]
        doc = np.asarray(docs[i], np.int32)
        pos = 0
        index[i] = (len(shards), fill)
        while pos < len(doc):
            take = min(shard_len - fill, len(doc) - pos)
            cur[fill : fill + take] = doc[pos : pos + take]
            cur_did[fill : fill + take] = i
            fill += take
            pos += take
            if fill == shard_len:
                flush()
    flush()
    return TokenShards(
        np.stack(shards) if shards else np.zeros((0, shard_len), np.int32),
        np.stack(dids) if dids else np.zeros((0, shard_len), np.int32),
        np.asarray(skeys, np.int32),
        index,
    )


def synthetic_corpus(
    n_docs: int = 512,
    vocab: int = 1024,
    mean_len: int = 384,
    n_sources: int = 4,
    seed: int = 0,
) -> Tuple[List[np.ndarray], List[int]]:
    """Zipf-ish seeded corpus for tests/examples (per-source token bias)."""
    rng = np.random.default_rng(seed)
    docs = []
    srcs = []
    for i in range(n_docs):
        src = int(rng.integers(n_sources))
        ln = max(8, int(rng.poisson(mean_len)))
        base = rng.zipf(1.4, size=ln) % (vocab // 2)
        toks = (base + src * (vocab // 2) // n_sources) % vocab
        docs.append(toks.astype(np.int32))
        srcs.append(src)
    return docs, srcs
