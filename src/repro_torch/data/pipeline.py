"""Deterministic, seekable synthetic data (``repro.data.pipeline``,
rewritten for PyTorch).

Batches are pure functions of ``(seed, step)``, drawn from the JAX
package's threefry keys (:mod:`repro_torch.prng`): ``fold_in(PRNGKey(seed),
step)`` split in 3, one key each for the tokens, the patches and the
frames.  So a step's batch is the reference's, and any step's batch is
regenerated without replaying the stream, which is all that
checkpoint/restart and preemption need of the data.  Token ids come from
fp32 uniforms through the reference's Zipf-like inverse CDF
(:func:`_tokens`); patches and frames are bf16 normals times 0.02.  The
draws run on ``device`` (the threefry kernel on the card, the plain
version on the CPU).  Token ids are int64, the index type of PyTorch's
embedding and gather (the reference's are int32).
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Tuple

import torch

from .. import prng
from ..configs.base import ArchConfig
from ..configs.shapes import InputShape
from ..kernels import threefry


@dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    # Synthetic distribution: Zipf-ish over the vocabulary, matching the
    # heavy-tailed rank-frequency shape of natural text.
    zipf_alpha: float = 1.1


def _tokens(u: torch.Tensor, vocab: int, alpha: float) -> torch.Tensor:
    """Zipf-distributed token ids via inverse-CDF on uniform draws ``u``:
    rank ~ u^(-1/(alpha-1)), truncated to the vocabulary (alpha > 1).  The
    power is taken in float64 and rounded to float32, which agrees with
    XLA's float32 ``pow`` far more often than torch's does (a floor
    flips where they differ)."""
    e = prng.round_f32(-1.0 / (alpha - 1.0))
    ranks = torch.floor((u.double() ** e).float()) - 1.0
    return torch.clamp(ranks, 0, vocab - 1).to(torch.int64)


def batch_for_step(cfg: ArchConfig, shape: InputShape, step: int,
                   data_cfg: DataConfig = DataConfig(),
                   device=None) -> Dict[str, torch.Tensor]:
    """The reference's global batch for ``step``, drawn on ``device``
    (the CPU if None)."""
    device = torch.device("cpu") if device is None else torch.device(device)
    ks = prng.split(prng.fold_in(prng.key(data_cfg.seed), step), 3)
    n_text = shape.seq_len - (cfg.n_patches or 0)
    u = threefry.draw(torch.empty((shape.global_batch, n_text),
                                  device=device), ks[0], "uniform",
                      lo=1e-6, hi=1.0)
    batch = {"tokens": _tokens(u, cfg.vocab_size, data_cfg.zipf_alpha)}
    if cfg.n_patches:
        batch["patches"] = threefry.draw(torch.empty(
            (shape.global_batch, cfg.n_patches, cfg.d_model),
            dtype=torch.bfloat16, device=device), ks[1], "normal",
            scale=0.02, bf16_math=True)
    if cfg.encoder is not None:
        batch["frames"] = threefry.draw(torch.empty(
            (shape.global_batch, cfg.encoder.n_frames, cfg.d_model),
            dtype=torch.bfloat16, device=device), ks[2], "normal",
            scale=0.02, bf16_math=True)
    return batch


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
