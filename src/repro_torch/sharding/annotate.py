"""Activation sharding annotations (``repro.sharding.annotate``), as
``DTensor.redistribute`` calls.

Two profiles, the reference's:

* ``cp``  -- context parallelism: activations [B, S, D] sharded batch over
  the data axes and sequence over ``model``; attention replicates
  (all-gathers) the small GQA/MLA KV across ``model`` and computes with
  sequence-sharded queries, each rank at its global query offset.  Used by
  every attention-family architecture.
* ``tp``  -- tensor parallelism over channels/heads: activations sharded
  batch-only; mixer-internal tensors shard their channel/head axis over
  ``model``.  Used by the recurrent architectures (mamba2,
  recurrentgemma), whose sequential scans keep the sequence axis local.

Every hook degrades gracefully: an axis whose size does not divide its
mesh axis is left unsharded, so the same model code runs on one device
(:data:`NULL_SHARDER`, plain tensors) and on the 512-way production mesh
(:class:`Sharder`, DTensors).  ``constraint`` is the reference's
``with_sharding_constraint``: the tensor is redistributed to the planned
placements (a no-op where it already has them).
"""

from __future__ import annotations

import math
from typing import Tuple

from .specs import placements


class NullSharder:
    """No-op sharder for single-device runs and unit tests."""

    profile = "null"
    mesh = None

    def activations(self, x):
        return x

    def logits(self, x):
        return x

    def replicate_seq(self, kv):
        return kv

    def channels(self, x):
        return x

    def weight_for_batch(self, w, batch_size):
        return w

    def decode_activations(self, x):
        return x

    def constraint(self, x, *spec):
        return x


NULL_SHARDER = NullSharder()


class Sharder:
    def __init__(self, mesh, profile: str,
                 batch_axes: Tuple[str, ...] = ("data",),
                 model_axis: str = "model", full_dp: bool = False):
        if profile not in ("cp", "tp"):
            raise ValueError(f"unknown sharding profile {profile!r}")
        names = tuple(mesh.mesh_dim_names)
        self.mesh = mesh
        self.profile = profile
        self.batch_axes = tuple(a for a in batch_axes if a in names)
        self.model_axis = model_axis if model_axis in names else None
        # cp-profile archs without MoE fall into pure DP + FSDP when the
        # global batch divides the whole mesh: attention then runs fully
        # local, with no per-layer KV gather (the reference's full_dp).
        self.full_dp = full_dp

    # ------------------------------------------------------------- helpers
    def _axis_size(self, axes) -> int:
        if isinstance(axes, str):
            axes = (axes,)
        names = list(self.mesh.mesh_dim_names)
        n = 1
        for a in axes:
            n *= self.mesh.shape[names.index(a)]
        return n

    def _batch_spec(self, b: int):
        return self.batch_axes if (
            self.batch_axes and b % self._axis_size(self.batch_axes) == 0) \
            else None

    def _model_spec(self, dim: int):
        if self.model_axis and dim % self._axis_size(self.model_axis) == 0:
            return self.model_axis
        return None

    def _plan(self, b: int):
        """(batch axes, model_axis_free) for a tensor with batch size ``b``.

        tp profile (and ``full_dp``): when the global batch divides the
        WHOLE mesh, batch shards over (pod, data, model) -- pure FSDP + DP,
        activations scale as B / n_devices.  Otherwise batch uses the data
        axes and the model axis is free for sequence or channel sharding.
        """
        if (self.profile == "tp" or self.full_dp) and self.model_axis:
            full = self.batch_axes + (self.model_axis,)
            if b % self._axis_size(full) == 0:
                return full, False
        return self._batch_spec(b), True

    def constraint(self, x, *spec):
        return x.redistribute(self.mesh, placements(spec, self.mesh))

    # --------------------------------------------------------------- hooks
    def activations(self, x):
        """[B, S, D] between layers."""
        b_spec, model_free = self._plan(x.shape[0])
        s_spec = (self._model_spec(x.shape[1])
                  if (self.profile == "cp" and model_free) else None)
        return self.constraint(x, b_spec, s_spec, None)

    def logits(self, x):
        return self.activations(x)

    def replicate_seq(self, kv):
        """KV tensors gathered across ``model`` before attention (cp).
        Under tp the sequence is already local: keep whatever batch plan is
        active."""
        b_spec, model_free = self._plan(kv.shape[0])
        if self.profile == "cp" and model_free:
            b_spec = self._batch_spec(kv.shape[0])
        return self.constraint(kv, b_spec, *([None] * (kv.ndim - 1)))

    def channels(self, x):
        """[B, S, C] with the channel axis model-sharded (recurrent blocks);
        when the batch already occupies the model axis, C stays local."""
        b_spec, model_free = self._plan(x.shape[0])
        c_spec = self._model_spec(x.shape[2]) if model_free else None
        return self.constraint(x, b_spec, None, c_spec)

    def weight_for_batch(self, w, batch_size: int):
        """Under the full-mesh batch plan (tp), gather the small weight
        instead of re-gathering the activations per op."""
        if self.profile != "tp":
            return w
        _, model_free = self._plan(batch_size)
        if model_free:
            return w
        return self.constraint(w, *([None] * w.ndim))

    def decode_activations(self, x):
        """[B, D] single-token activations."""
        return self.constraint(x, self._batch_spec(x.shape[0]), None)


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def splittable(t, dim: int, parts: int):
    """``t`` ready to split ``dim`` into ``parts`` x rest: a DTensor's
    shards along ``dim`` are gathered unless their count divides ``parts``
    (DTensor cannot view a shard across the split); a plain tensor as it
    is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(t, DTensor):
        return t
    here = [isinstance(pl, Shard) and pl.dim == dim for pl in t.placements]
    n = math.prod(t.device_mesh.size(m) for m, h in enumerate(here) if h)
    if parts % n == 0:
        return t
    return t.redistribute(t.device_mesh, [Replicate() if h else pl for h, pl
                                          in zip(here, t.placements)])


def profile_for(cfg) -> str:
    """Sharding profile for an architecture (see module docstring)."""
    return "tp" if (cfg.ssm is not None or cfg.rglru is not None) else "cp"
