"""Input pipeline — the dataflow template applied to the host boundary.

The port of the reference's ``data/pipeline.py``.  The training step's
first "memory operation" is the batch fetch itself.  Per the template,
it gets its own decoupled stage: a producer thread makes the next
batches and copies them to the device into a bounded :class:`HostFIFO`
while the device computes the current step — host latency is hidden
exactly like a cache miss behind a long-latency FMA stage (§II).

Sources: a deterministic synthetic LM stream (self-contained benchmarks)
and a memory-mapped token-file reader for real corpora.  Both are the
reference's numpy code, so a ``(seed, step)`` gives the reference's
batch bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from .._device import get_device
from ..core.channels import HostFIFO


@dataclasses.dataclass
class DataConfig:
    batch_size: int = 8
    seq_len: int = 128
    vocab_size: int = 256
    seed: int = 0
    prefetch_depth: int = 4


def synthetic_stream(cfg: DataConfig, *, start_step: int = 0
                     ) -> Iterator[dict]:
    """Deterministic synthetic LM data with learnable structure (a noisy
    periodic token process — losses actually go down on it).

    Deterministic in ``step`` so that checkpoint-resume reproduces the
    exact same batch sequence (required by the fault-tolerance test).
    """
    step = start_step
    while True:
        rng = np.random.default_rng((cfg.seed, step))
        B, S = cfg.batch_size, cfg.seq_len
        pos = np.arange(S + 1)[None, :] + rng.integers(
            0, cfg.vocab_size, (B, 1))
        period = rng.integers(3, 11, (B, 1))
        base = (pos // period * period) % cfg.vocab_size
        noise = rng.integers(0, cfg.vocab_size, (B, S + 1))
        mask = rng.random((B, S + 1)) < 0.1
        tokens = np.where(mask, noise, base).astype(np.int32)
        yield {"tokens": tokens, "step": step}
        step += 1


def file_stream(path: str, cfg: DataConfig, *, start_step: int = 0
                ) -> Iterator[dict]:
    """Reads a flat .npy/.bin int32 token file (memory-mapped), cutting
    deterministic (batch, seq+1) windows."""
    tokens = np.memmap(path, dtype=np.int32, mode="r")
    n = len(tokens)
    B, S = cfg.batch_size, cfg.seq_len
    step = start_step
    while True:
        rng = np.random.default_rng((cfg.seed, step))
        starts = rng.integers(0, n - (S + 1), size=(B,))
        batch = np.stack([tokens[s:s + S + 1] for s in starts])
        yield {"tokens": batch.astype(np.int32), "step": step}
        step += 1


def prefetched(source: Iterator[dict], depth: int = 4,
               device: str | torch.device | None = None) -> HostFIFO:
    """Wrap a source in the bounded prefetch FIFO, its batches made into
    tensors on ``device`` (default: the port's device policy) on the
    producer thread.  To a CUDA device each batch goes from pinned memory
    with ``non_blocking=True``, queued on the device's default stream, so
    the step that reads it runs after the copy and the producer never
    waits for the card."""
    dev = get_device(device)

    def transform(item: dict) -> dict:
        arr = torch.from_numpy(item["tokens"])
        if dev.type == "cuda":
            arr = arr.pin_memory().to(dev, non_blocking=True)
        return {"tokens": arr, "step": item["step"]}

    return HostFIFO(source, depth=depth, transform=transform)
