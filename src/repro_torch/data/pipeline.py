"""Data pipeline: background prefetch and device placement.  The
counterpart of src/repro/data/pipeline.py.

A producer thread stays ``PREFETCH`` steps ahead of the training loop, so
the host's batch generation (numpy, ``SyntheticLM``) overlaps the device's
step.  Each batch is ``SyntheticLM.batch_for_step(step)``, plus the stub
frontend input (``frontend_for_step``) under ``frontend_input_name(cfg)``
where the model config has a frontend, moved to ``device`` (the card
unless the caller asks for the CPU) as torch tensors; the reference's
sharded ``jax.device_put`` becomes ``.to(device)``.  The arrays are the
reference's, bit for bit.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Tuple

import torch

from repro_torch.data.synthetic import DataConfig, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.models import modality

#: batches the producer thread keeps queued ahead of the training loop (the
#: reference's default ``prefetch``)
PREFETCH = 2


class Pipeline:
    """Iterate ``(step, batch)`` from ``start_step`` on; ``close()`` stops
    the producer thread and waits for it to end.  An exception raised
    while the thread makes a batch is raised by the ``next`` that would
    have returned that batch."""

    def __init__(self, data_cfg: DataConfig, model_cfg, start_step: int = 0,
                 device="cuda"):
        self.source = SyntheticLM(data_cfg)
        self.model_cfg = model_cfg
        self.device = resolve_device(device)
        self._q: queue.Queue = queue.Queue(maxsize=PREFETCH)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def make_batch(self, step: int) -> Dict[str, torch.Tensor]:
        """Step ``step``'s batch: {"tokens", "labels"} int32 (B, S) and,
        with a frontend, its input float32 (B, P, d), on the device."""
        batch = self.source.batch_for_step(step)
        cfg = self.model_cfg
        if cfg.frontend:
            batch[modality.frontend_input_name(cfg)] = \
                self.source.frontend_for_step(step, cfg.frontend_len,
                                              cfg.d_model)
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in batch.items()}

    def _put(self, item) -> bool:
        """Queue ``item``, waiting for room until ``close()``; whether it
        was queued."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def _producer(self):
        step = self._step
        try:
            while self._put((step, self.make_batch(step))):
                step += 1
        except Exception as err:    # handed to the consumer, which raises it
            self._put(err)

    def __iter__(self):
        return self

    def __next__(self) -> Tuple[int, Dict[str, torch.Tensor]]:
        item = self._q.get()
        if isinstance(item, Exception):
            raise item
        return item

    def close(self):
        self._stop.set()
        self._thread.join()
