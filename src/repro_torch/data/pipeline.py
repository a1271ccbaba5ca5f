"""Deterministic synthetic LM data pipeline.

Production-shaped: shardable across data-parallel hosts (each host generates
only its shard), background prefetch thread with bounded queue, and an
explicitly checkpointable iterator state (carried inside burst-buffer
checkpoints, so restore resumes the exact batch sequence — determinism is
what makes the failure-injection integration test bit-exact).

Batches are Zipf-ish token sequences with a shifted-copy labels field, plus
optional stub modality inputs (frame/patch embeddings) for audio/vlm archs.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


class SyntheticLMPipeline:
    def __init__(self, *, vocab_size: int, seq_len: int, global_batch: int,
                 shard_id: int = 0, num_shards: int = 1, seed: int = 1234,
                 enc_seq: int = 0, enc_dim: int = 0,
                 prefetch: int = 2):
        assert global_batch % num_shards == 0
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.local_batch = global_batch // num_shards
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.seed = seed
        self.enc_seq = enc_seq
        self.enc_dim = enc_dim
        self.step = 0
        self._queue: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._worker: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # --------------------------------------------------------- deterministic
    def _batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            (self.seed, step, self.shard_id))
        # zipf-ish marginal over the vocab, clipped
        raw = rng.zipf(1.3, size=(self.local_batch, self.seq_len + 1))
        tokens = (raw % (self.vocab_size - 1)).astype(np.int32) + 1
        batch = {"inputs": tokens[:, :-1], "labels": tokens[:, 1:]}
        if self.enc_seq:
            batch["enc_input"] = rng.normal(
                0, 1, (self.local_batch, self.enc_seq, self.enc_dim)
            ).astype(np.float32)
        return batch

    # ------------------------------------------------------------- iterator
    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        if self._worker is None:
            batch = self._batch_at(self.step)
        else:
            batch = self._queue.get()
        self.step += 1
        return batch

    # ------------------------------------------------------------- prefetch
    def start_prefetch(self):
        if self._worker is not None:
            return self
        self._stop.clear()
        next_step = [self.step]

        def work():
            while not self._stop.is_set():
                b = self._batch_at(next_step[0])
                while not self._stop.is_set():
                    try:
                        self._queue.put(b, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                next_step[0] += 1

        self._worker = threading.Thread(target=work, daemon=True)
        self._worker.start()
        return self

    def stop_prefetch(self):
        self._stop.set()
        if self._worker is not None:
            self._worker.join(timeout=2)
            self._worker = None
        while not self._queue.empty():
            self._queue.get_nowait()

    # ----------------------------------------------------------- checkpoint
    def state_dict(self) -> Dict[str, int]:
        return {"step": self.step, "seed": self.seed,
                "shard_id": self.shard_id, "num_shards": self.num_shards}

    def load_state_dict(self, state: Dict[str, int]):
        assert state["seed"] == self.seed
        assert state["num_shards"] == self.num_shards
        was_prefetching = self._worker is not None
        if was_prefetching:
            self.stop_prefetch()
        self.step = int(state["step"])
        if was_prefetching:
            self.start_prefetch()
