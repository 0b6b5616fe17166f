"""Synthetic tokenized data pipeline: deterministic, shardable, epochless.

Stands in for a tokenized corpus: documents are variable-length Zipf token
spans packed into fixed-length rows (standard document-packing), generated
on the fly from the (seed, step, row) key so every data shard is
reproducible and no host I/O is needed.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3
    mean_doc_len: int = 96
    eos_token: int = 1


class PackedStream:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def _row(self, step: int, row: int) -> np.ndarray:
        c = self.cfg
        rng = np.random.default_rng((c.seed * 1_000_003 + step) * 4099 + row)
        toks = np.empty(0, np.int32)
        while len(toks) < c.seq_len + 1:
            n = max(2, int(rng.exponential(c.mean_doc_len)))
            doc = rng.zipf(c.zipf_a, n).astype(np.int32) % (c.vocab_size - 2) + 2
            toks = np.concatenate([toks, doc, [c.eos_token]])
        return toks[: c.seq_len + 1]

    def batch(self, step: int, shard: int = 0, num_shards: int = 1) -> dict:
        """Return the shard's slice of the global batch for `step`."""
        c = self.cfg
        rows_per_shard = c.global_batch // num_shards
        rows = [self._row(step, shard * rows_per_shard + r)
                for r in range(rows_per_shard)]
        arr = np.stack(rows)
        return {"tokens": arr[:, :-1].astype(np.int32),
                "labels": arr[:, 1:].astype(np.int32)}
