"""Training and serving jobs for the lane executor (``repro.core.jobs``),
built on the PyTorch model.

A training job's block is one optimizer step on a fixed-size batch; a
serving job's block is one k-token decode chunk for a request batch
against its live cache (attention KV caches, Mamba-2 and RG-LRU states,
whatever the arch's plan keeps), and its first block runs the prefill too.
Blocks are homogeneous, the structural property the paper's predictor
exploits.  Nothing here depends on the arch: any config the port's model
runs makes a serving and a training job.  As in the JAX package, both
feed the model tokens alone: whisper-large-v3 runs its decoder with cross
attention skipped, pixtral-12b its text path.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from .. import prng, resolve_device
from ..checkpoint.checkpointer import Checkpointer
from ..configs.base import ArchConfig
from ..models import lm
from ..optim import adamw
from ..tree import leaves
from .executor import ExecutorJob


def _sync(device: torch.device) -> None:
    # The executor times a block with the host clock around the call, so a
    # block must end when the device is done (the analogue of
    # jax.block_until_ready); otherwise the predictor samples launch latency.
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_tokens(cfg: ArchConfig, seed: int, block: int, batch: int,
                 seq: int) -> torch.Tensor:
    """Block ``block``'s token ids of a training job, the reference's
    ``randint(fold_in(PRNGKey(seed + 1), block), (batch, seq), 0,
    vocab)`` (int64, on the CPU)."""
    return prng.randint(prng.fold_in(prng.key(seed + 1), block),
                        (batch, seq), 0, cfg.vocab_size)


def serve_prompt(cfg: ArchConfig, seed: int, batch: int,
                 prompt_len: int) -> torch.Tensor:
    """A serving job's prompt, the reference's ``randint(PRNGKey(seed),
    (batch, prompt_len), 0, vocab)`` (the weights' key, as there; int64,
    on the CPU)."""
    return prng.randint(prng.key(seed), (batch, prompt_len), 0,
                        cfg.vocab_size)


def make_train_job(
    cfg: ArchConfig,
    name: str,
    *,
    blocks: int,
    batch: int = 4,
    seq: int = 64,
    max_residency: int = 4,
    arrival: float = 0.0,
    seed: int = 0,
    opt_cfg: adamw.OptConfig = adamw.OptConfig(lr=1e-3, warmup_steps=5,
                                               total_steps=1000),
    checkpointer: Optional[Checkpointer] = None,
    checkpoint_every: int = 0,
    resume: bool = False,
    tenant: Optional[str] = None,
    device=None,
) -> ExecutorJob:
    """A training job: ``blocks`` optimizer steps of ``cfg`` on
    ``device``.

    Blocks update the job's (params, opt_state), held in a closure, in
    place; preemption happens only at block boundaries, so the state is
    always consistent and a checkpoint (every ``checkpoint_every`` blocks,
    if configured) needs no extra coordination.  With ``resume`` the job
    restores the checkpointer's latest step and runs only the blocks left.
    Weights are ``lm.init(cfg, seed=seed)`` in fp32, stacked; block ``i``
    trains on the reference's token ids (:func:`train_tokens`; no frames
    or patches, as the reference's job), so a resumed job sees the batches
    it would have seen.
    """
    device = resolve_device(device)
    params = lm.init(cfg, seed=seed, device=device, dtype=torch.float32,
                     stacked=True)
    for p in leaves(params):
        p.requires_grad_()
    state = {"params": params, "opt": adamw.init(params), "block": 0}
    if resume and checkpointer is not None \
            and checkpointer.latest_step() is not None:
        step, restored, _ = checkpointer.restore(
            {"params": state["params"], "opt": state["opt"]})
        state["params"], state["opt"] = restored["params"], restored["opt"]
        state["block"] = step

    def tokens_for(i: int) -> torch.Tensor:
        return train_tokens(cfg, seed, i, batch, seq).to(device)

    def grads(params, tokens):
        loss, _ = lm.loss_fn(cfg, params, {"tokens": tokens})
        return torch.autograd.grad(loss, leaves(params))

    def warmup():
        # Pays every one-time cost (kernel build and load, allocator
        # growth) with a forward and backward whose gradients are
        # discarded: the job's state is untouched.
        grads(state["params"], tokens_for(0))
        _sync(device)

    def make_block_fn(residency: int) -> Callable[[], None]:
        def block():
            i = state["block"]
            p, o = state["params"], state["opt"]
            adamw.update(list(grads(p, tokens_for(i))), o, leaves(p),
                         opt_cfg)
            _sync(device)
            state["block"] = i + 1
            if (checkpointer is not None and checkpoint_every
                    and (i + 1) % checkpoint_every == 0):
                checkpointer.save(i + 1, {"params": p, "opt": o},
                                  {"job": name})
        return block

    return ExecutorJob(name=name, num_blocks=blocks - state["block"],
                       max_residency=max_residency,
                       make_block_fn=make_block_fn, arrival=arrival,
                       warmup_fn=warmup, tenant=tenant)


def make_serve_job(
    cfg: ArchConfig,
    name: str,
    *,
    blocks: int,
    tokens_per_block: int = 8,
    batch: int = 2,
    prompt_len: int = 16,
    max_residency: int = 4,
    arrival: float = 0.0,
    seed: int = 0,
    tenant: Optional[str] = None,
    prompt=None,
    device=None,
) -> ExecutorJob:
    """A serving job: ``blocks`` decode chunks of ``tokens_per_block`` each
    against a live cache (prefill happens in the first block).

    Weights come from ``lm.init(cfg, seed=seed)``.  ``prompt`` ([batch,
    prompt_len] token ids, a tensor or numpy array) defaults to the
    reference's (:func:`serve_prompt`).
    """
    device = resolve_device(device)
    max_seq = prompt_len + blocks * tokens_per_block + 8
    params = lm.init(cfg, seed=seed, device=device)
    if prompt is None:
        prompt = serve_prompt(cfg, seed, batch, prompt_len)
    prompt = torch.as_tensor(np.asarray(prompt) if not torch.is_tensor(prompt)
                             else prompt).to(device=device, dtype=torch.long)
    if tuple(prompt.shape) != (batch, prompt_len):
        raise ValueError(f"prompt shape {tuple(prompt.shape)}, expected "
                         f"{(batch, prompt_len)}")
    state: Dict = {"caches": None, "lengths": None, "token": None}

    def do_prefill():
        return lm.prefill(cfg, params, prompt, max_seq=max_seq)

    def do_decode(token, caches, lengths):
        logits, caches = lm.decode_step(cfg, params, token, caches, lengths)
        return torch.argmax(logits, -1), caches

    def warmup():
        # Pays every one-time cost (kernel build and load, allocator growth)
        # on caches of its own: the job's state is untouched.
        logits, caches = do_prefill()
        lengths = torch.full((batch,), prompt_len, dtype=torch.int32,
                             device=device)
        do_decode(torch.argmax(logits, -1), caches, lengths)
        _sync(device)

    def make_block_fn(residency: int) -> Callable[[], None]:
        def block():
            if state["caches"] is None:
                logits, caches = do_prefill()
                state["caches"] = caches
                state["lengths"] = torch.full((batch,), prompt_len,
                                              dtype=torch.int32, device=device)
                state["token"] = torch.argmax(logits, -1)
            for _ in range(tokens_per_block):
                tok, caches = do_decode(state["token"], state["caches"],
                                        state["lengths"])
                state["token"] = tok
                state["caches"] = caches
                state["lengths"] = state["lengths"] + 1
            _sync(device)
        return block

    return ExecutorJob(name=name, num_blocks=blocks,
                       max_residency=max_residency,
                       make_block_fn=make_block_fn, arrival=arrival,
                       warmup_fn=warmup, tenant=tenant)
