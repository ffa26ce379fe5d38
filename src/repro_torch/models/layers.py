"""Shared model building blocks (``repro.models.layers``), on tensors.

Conventions follow the JAX package: weight shapes put the contraction
(input) dim first (``w[d_in, d_out]``); norms compute in float32 and cast
back; rotary embedding rotates split halves, not interleaved pairs.

The JAX package stores weights in float32 and casts them to the compute
dtype at every use.  The port casts matrices once, when parameters are
loaded (:mod:`repro_torch.models.bridge`): the values that reach each
product are the same, and a decode step reads half the bytes.  Norm scales
and biases stay float32, because the JAX package multiplies by them in
float32.  :func:`cast` is then a no-op on the hot path.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

DEFAULT_COMPUTE_DTYPE = torch.bfloat16


def cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x if x.dtype == dtype else x.to(dtype)


# ------------------------------------------------------------------- norms
def apply_norm(p: Dict, x: torch.Tensor, kind: str = "rms",
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if kind == "rms":
        xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
        xf = (xf - mu) * torch.rsqrt(var + eps)
    out = xf * p["scale"]
    if "bias" in p:
        out = out + p["bias"]
    return out.to(x.dtype)


# -------------------------------------------------------------- embeddings
def embed(p: Dict, tokens: torch.Tensor,
          dtype: torch.dtype = DEFAULT_COMPUTE_DTYPE) -> torch.Tensor:
    return cast(p["table"], dtype)[tokens]


def unembed(p: Dict, x: torch.Tensor,
            dtype: torch.dtype = DEFAULT_COMPUTE_DTYPE) -> torch.Tensor:
    return x @ cast(p["table"], dtype).T


# -------------------------------------------------------------------- rope
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotary embedding.  x: [..., S, H, D]; positions: [..., S]."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                   # [D/2]
    angles = positions[..., :, None].float() * freqs         # [..., S, D/2]
    cos = torch.cos(angles)[..., :, None, :]                 # [..., S, 1, D/2]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------- activation
def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (the tanh approximation, its default), step by step
    in x's dtype as JAX computes it.  ``F.gelu(x, approximate="tanh")``
    rounds once; in bf16 about half its outputs then differ from JAX's by
    an ulp, which compounds across the recurrent layers of the hybrid
    model past the bf16 parity bound."""
    # constants in x's dtype, as JAX's weakly typed scalars are
    c, k = (torch.tensor(v, dtype=x.dtype)
            for v in (math.sqrt(2 / math.pi), 0.044715))
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * x ** 3))))


# --------------------------------------------------------------------- mlp
def apply_mlp(p: Dict, x: torch.Tensor, act: str,
              dtype: torch.dtype = DEFAULT_COMPUTE_DTYPE) -> torch.Tensor:
    def lin(q, v):
        y = v @ cast(q["w"], dtype)
        if "b" in q:
            y = y + cast(q["b"], dtype)
        return y

    if act == "swiglu":
        h = F.silu(lin(p["gate"], x)) * lin(p["up"], x)
    elif act == "geglu":
        h = gelu_tanh(lin(p["gate"], x)) * lin(p["up"], x)
    else:
        h = gelu_tanh(lin(p["up"], x))
    return lin(p["down"], h)
