"""Training and serving jobs for the lane executor (``repro.core.jobs``),
built on the PyTorch model.

A training job's block is one optimizer step on a fixed-size batch; a
serving job's block is one k-token decode chunk for a request batch
against its live cache (attention KV caches, Mamba-2 and RG-LRU states,
whatever the arch's plan keeps), and its first block runs the prefill too.
Blocks are homogeneous, the structural property the paper's predictor
exploits.  On the card a serving job captures its decode step once, at
warm-up, as a CUDA graph and every block replays it, as the reference's
jitted step is compiled at warm-up (:class:`DecodeStep`); its prefill, run
once a job, stays eager.  Nothing here depends on the arch: any config
the port's model runs makes a serving and a training job.  As in the JAX
package, both feed the model tokens alone: whisper-large-v3 runs its
decoder with cross attention skipped, pixtral-12b its text path.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from .. import graphs, prng, resolve_device
from ..checkpoint.checkpointer import Checkpointer
from ..configs.base import ArchConfig
from ..kernels import threefry
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
                 seq: int, device=None) -> torch.Tensor:
    """Block ``block``'s token ids of a training job, the reference's
    ``randint(fold_in(PRNGKey(seed + 1), block), (batch, seq), 0,
    vocab)``, drawn on ``device`` (the CPU if None; int64)."""
    return threefry.randint(prng.fold_in(prng.key(seed + 1), block),
                            (batch, seq), 0, cfg.vocab_size, device=device)


def serve_prompt(cfg: ArchConfig, seed: int, batch: int, prompt_len: int,
                 device=None) -> torch.Tensor:
    """A serving job's prompt, the reference's ``randint(PRNGKey(seed),
    (batch, prompt_len), 0, vocab)`` (the weights' key, as there), drawn
    on ``device`` (the CPU if None; int64)."""
    return threefry.randint(prng.key(seed), (batch, prompt_len), 0,
                            cfg.vocab_size, device=device)


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
    trains on the reference's token ids (:func:`train_tokens`, drawn on
    ``device`` inside the block, as the reference draws them inside its
    step; no frames or patches, as the reference's job), so a resumed job
    sees the batches it would have seen.
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
        return train_tokens(cfg, seed, i, batch, seq, device)

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


def decode_in_place(cfg: ArchConfig, params: Dict, token: torch.Tensor,
                    caches: Dict, lengths: torch.Tensor) -> torch.Tensor:
    """One decode step on buffers a serve job keeps across steps, the body
    its CUDA graph captures: the caches updated in place, the step's
    argmax written into ``token`` (int64 ``[B]``) and ``lengths`` (int32
    ``[B]``) advanced in place, so steps follow each other with no host
    work between them.  Returns the logits ``[B, V]``."""
    logits, _ = lm.decode_step(cfg, params, token, caches, lengths)
    token.copy_(torch.argmax(logits, -1))
    lengths.add_(1)
    return logits


class DecodeStep:
    """A serve job's prefill and decode step on buffers it keeps: the
    counterpart of the reference's jitted ``do_prefill`` and ``do_decode``.

    ``token``, ``lengths`` and the caches (those of the first
    :meth:`prefill`) keep their storage for the job's life.  A later
    :meth:`prefill` overwrites every leaf of the caches with a fresh
    prefill's, and the token and lengths, so nothing of an earlier step
    (a warm-up's) leaks into the next: attention keys past the prompt are
    masked by ``lengths``, but Mamba-2's and the RG-LRU's states are read
    whole.  :meth:`capture` captures one decode step as a CUDA graph
    (:mod:`repro_torch.graphs`); each call then replays it.  Without a
    capture (the CPU) a call runs the step eagerly.
    """

    def __init__(self, cfg: ArchConfig, params: Dict, prompt: torch.Tensor,
                 max_seq: int):
        self.cfg, self.params, self.prompt = cfg, params, prompt
        self.max_seq = max_seq
        batch = prompt.shape[0]
        self.token = torch.zeros(batch, dtype=torch.long,
                                 device=prompt.device)
        self.lengths = torch.zeros(batch, dtype=torch.int32,
                                   device=prompt.device)
        self.caches: Optional[Dict] = None
        self.graph: Optional[graphs.Graph] = None

    def prefill(self) -> None:
        """Run the prompt into the caches; the token is its argmax and
        ``lengths`` the prompt's length."""
        logits, caches = lm.prefill(self.cfg, self.params, self.prompt,
                                    max_seq=self.max_seq)
        if self.caches is None:
            self.caches = caches
        else:
            for dst, src in zip(leaves(self.caches), leaves(caches)):
                dst.copy_(src)
        self.token.copy_(torch.argmax(logits, -1))
        self.lengths.fill_(self.prompt.shape[1])

    def capture(self) -> None:
        """Capture one decode step (after a :meth:`prefill`) as a CUDA
        graph; it runs the step eagerly a few times first, writing the
        buffers, which the next :meth:`prefill` overwrites."""
        if self.caches is None:
            raise RuntimeError("capture needs the caches of a prefill")
        self.graph = graphs.capture(
            lambda: decode_in_place(self.cfg, self.params, self.token,
                                    self.caches, self.lengths),
            self.prompt.device)

    def __call__(self) -> torch.Tensor:
        """One decode step: the graph's replay once captured, else eager.
        Returns the logits (a replay's are the graph's output buffer,
        overwritten by the next)."""
        if self.graph is not None:
            return self.graph.replay()
        return decode_in_place(self.cfg, self.params, self.token,
                               self.caches, self.lengths)


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
    reference's (:func:`serve_prompt`).  On the card the warm-up captures
    the decode step as a CUDA graph, as the reference's warm-up compiles
    it, and every block replays it (:class:`DecodeStep`); a failed capture
    raises.  On the CPU the steps run eagerly.
    """
    device = resolve_device(device)
    max_seq = prompt_len + blocks * tokens_per_block + 8
    params = lm.init(cfg, seed=seed, device=device)
    if prompt is None:
        prompt = serve_prompt(cfg, seed, batch, prompt_len, device)
    prompt = torch.as_tensor(np.asarray(prompt) if not torch.is_tensor(prompt)
                             else prompt).to(device=device, dtype=torch.long)
    if tuple(prompt.shape) != (batch, prompt_len):
        raise ValueError(f"prompt shape {tuple(prompt.shape)}, expected "
                         f"{(batch, prompt_len)}")
    step = DecodeStep(cfg, params, prompt, max_seq)
    state = {"fresh": True}

    def warmup():
        # Pays every one-time cost (kernel build and load, allocator
        # growth) and on the card captures the decode step (the CPU runs
        # it once, eagerly); the job's results are untouched, since the
        # first block's prefill overwrites every buffer the warm-up wrote.
        step.prefill()
        if device.type == "cuda":
            step.capture()
        else:
            step()
        _sync(device)

    def make_block_fn(residency: int) -> Callable[[], None]:
        def block():
            if device.type == "cuda" and step.graph is None:
                raise RuntimeError(f"serve job {name!r}: the warm-up "
                                   f"captures the decode step; run "
                                   f"warmup_fn before the first block")
            if state["fresh"]:
                step.prefill()
                state["fresh"] = False
            for _ in range(tokens_per_block):
                step()
            _sync(device)
        return block

    return ExecutorJob(name=name, num_blocks=blocks,
                       max_residency=max_residency,
                       make_block_fn=make_block_fn, arrival=arrival,
                       warmup_fn=warmup, tenant=tenant)
