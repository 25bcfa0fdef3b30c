"""Deterministic synthetic data pipeline, sharded and prefetched (port of
``repro/data/pipeline.py``).

Batches are generated per ``(step, host)`` from a counter-based numpy
generator, exactly as the reference generates them, so any host can
regenerate any shard (checkpoint restart and elastic re-sharding stay
consistent) and the two packages see bitwise the same batches.  Labels are
the tokens shifted left (next-token prediction); for embed-input families
the pipeline synthesizes embeddings and labels, the last label masked.
:meth:`SyntheticPipeline.device_batch` puts a batch on ``device``: on the
card through pinned host memory with ``non_blocking`` copies.  A
background thread prefetches device batches into a bounded queue.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from ..core.analyzer import _check_device

__all__ = ["SyntheticPipeline"]


class SyntheticPipeline:
    def __init__(
        self,
        cfg,  # ModelConfig
        batch: int,
        seq_len: int,
        seed: int = 0,
        n_hosts: int = 1,
        host_id: int = 0,
        prefetch: int = 2,
        device="cuda",
    ):
        self.cfg = cfg
        self.batch = batch
        self.seq_len = seq_len
        self.seed = seed
        self.n_hosts = n_hosts
        self.host_id = host_id
        if batch % n_hosts:
            raise ValueError("global batch must divide across hosts")
        self.local_batch = batch // n_hosts
        self.device = _check_device(device)
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ------------------------------------------------------------------ #

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Deterministic batch for (step, host): restartable anywhere."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_id])
        )
        if self.cfg.embed_inputs:
            toks = rng.integers(
                0, self.cfg.vocab_size, (self.local_batch, self.seq_len + 1), dtype=np.int32
            )
            out = {"tokens": toks[:, :-1]}
            labels = toks[:, 1:].copy()
        else:
            out = {
                "embeds": rng.standard_normal(
                    (self.local_batch, self.seq_len, self.cfg.d_model), dtype=np.float32
                )
            }
            labels = rng.integers(
                0, self.cfg.vocab_size, (self.local_batch, self.seq_len), dtype=np.int32
            )
            labels[:, -1] = -1
        out["labels"] = labels
        return out

    def device_batch(self, step: int) -> Dict[str, torch.Tensor]:
        """:meth:`batch_at` on the pipeline's device, dtypes kept."""
        out = {}
        for k, v in self.batch_at(step).items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if self.device.type == "cuda":
                out[k] = t.pin_memory().to(self.device, non_blocking=True)
            else:
                out[k] = t
        return out

    # ------------------------------------------------------------------ #
    # background prefetch
    # ------------------------------------------------------------------ #

    def start(self, first_step: int = 0):
        self._stop.clear()

        def worker():
            step = first_step
            while not self._stop.is_set():
                try:
                    self._q.put(self.device_batch(step), timeout=0.2)
                    step += 1
                except queue.Full:
                    continue

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()
        return self

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        while True:
            yield self._q.get()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
