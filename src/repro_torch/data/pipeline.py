"""Deterministic, seekable synthetic data (``repro.data.pipeline``,
rewritten for PyTorch).

Batches are pure functions of ``(seed, step)``: every draw comes from a
CPU ``torch.Generator`` seeded from the seed, the step and the stream
(tokens, patches, frames), so any step's batch is regenerated without
replaying the stream, which is all that checkpoint/restart and preemption
need of the data.  The reference draws its uniforms from JAX's threefry
keys, which the port does not reproduce: the transform from uniforms to
token ids (:func:`_tokens`, a Zipf-like inverse CDF) is the reference's,
but the token ids of a step differ from the JAX package's.  Token ids are
int64, the index type of PyTorch's embedding and gather (the reference's
are int32).
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..configs.shapes import InputShape

_TOKENS, _PATCHES, _FRAMES = 0, 1, 2        # streams of one step


@dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    # Synthetic distribution: Zipf-ish over the vocabulary, matching the
    # heavy-tailed rank-frequency shape of natural text.
    zipf_alpha: float = 1.1


def generator(seed: int, step: int, stream: int = _TOKENS
              ) -> torch.Generator:
    """The CPU generator of one (seed, step, stream)."""
    state = np.random.SeedSequence([seed, step, stream]).generate_state(
        1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state))


def uniform(gen: torch.Generator, shape: Tuple[int, ...],
            minval: float = 1e-6, maxval: float = 1.0) -> torch.Tensor:
    """Uniform fp32 in [minval, maxval), as ``jax.random.uniform`` maps
    its [0, 1) floats: ``max(minval, u * (maxval - minval) + minval)``."""
    u = torch.rand(shape, generator=gen, dtype=torch.float32)
    return torch.clamp(u * (maxval - minval) + minval, min=minval)


def _tokens(u: torch.Tensor, vocab: int, alpha: float) -> torch.Tensor:
    """Zipf-distributed token ids via inverse-CDF on uniform draws ``u``:
    rank ~ u^(-1/(alpha-1)), truncated to the vocabulary (alpha > 1)."""
    ranks = torch.floor(u ** (-1.0 / (alpha - 1.0))) - 1.0
    return torch.clamp(ranks, 0, vocab - 1).to(torch.int64)


def batch_for_step(cfg: ArchConfig, shape: InputShape, step: int,
                   data_cfg: DataConfig = DataConfig(),
                   device=None) -> Dict[str, torch.Tensor]:
    """Global batch for ``step``, made on the CPU and moved to
    ``device``."""
    n_text = shape.seq_len - (cfg.n_patches or 0)
    u = uniform(generator(data_cfg.seed, step, _TOKENS),
                (shape.global_batch, n_text))
    batch = {"tokens": _tokens(u, cfg.vocab_size, data_cfg.zipf_alpha)}
    if cfg.n_patches:
        batch["patches"] = 0.02 * torch.randn(
            (shape.global_batch, cfg.n_patches, cfg.d_model),
            generator=generator(data_cfg.seed, step, _PATCHES)).to(
                torch.bfloat16)
    if cfg.encoder is not None:
        batch["frames"] = 0.02 * torch.randn(
            (shape.global_batch, cfg.encoder.n_frames, cfg.d_model),
            generator=generator(data_cfg.seed, step, _FRAMES)).to(
                torch.bfloat16)
    return {k: v.to(device) for k, v in batch.items()} if device is not None \
        else batch


def batch_spec(cfg: ArchConfig, shape: InputShape
               ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """(shape, dtype) of every entry of one global batch."""
    n_text = shape.seq_len - (cfg.n_patches or 0)
    spec = {"tokens": ((shape.global_batch, n_text), torch.int64)}
    if cfg.n_patches:
        spec["patches"] = ((shape.global_batch, cfg.n_patches, cfg.d_model),
                           torch.bfloat16)
    if cfg.encoder is not None:
        spec["frames"] = ((shape.global_batch, cfg.encoder.n_frames,
                           cfg.d_model), torch.bfloat16)
    return spec


def iterate(cfg: ArchConfig, shape: InputShape, start_step: int = 0,
            data_cfg: DataConfig = DataConfig(), prefetch: int = 2,
            device=None) -> Iterator[Dict[str, torch.Tensor]]:
    """Host-side iterator with background prefetch, resumable at any
    step."""
    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def producer():
        step = start_step
        while not stop.is_set():
            batch = batch_for_step(cfg, shape, step, data_cfg)
            while not stop.is_set():
                try:
                    q.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            batch = q.get()
            yield {k: v.to(device) for k, v in batch.items()} \
                if device is not None else batch
    finally:
        stop.set()
