"""Which bf16 rounding point of the SSD-scan backward costs its accuracy.

    python3 tools/ssd_bwd_rounding.py [--batch B]

Runs on the CPU.  ``ssd_bwd_plain(dtype=torch.bfloat16)`` rounds each
product's operands where the CUDA kernels round them; this tool builds
variants of that function's source that keep one rounding point in
float32 and prints each gradient's relative L2 error against the fp32
formula, at mamba2-2.7b's training widths (S 1024, 80 heads of P 64, G
1, N 128, chunk 128; the batch cut to ``--batch``, 1 by default), on
inputs drawn from a seed:

- ``kernel``: as the kernels round;
- ``hd_fp32``: <dh, h_c> from the fp32 states and state gradients;
- ``cb_fp32``: C·Bᵀ kept in fp32 until L = C·Bᵀ ∘ decay is formed (and
  in the row and column sums of Z ∘ C·Bᵀ);
- ``both``: the two together.

Prints one line per variant and a last JSON line.
"""

from __future__ import annotations

import argparse
import inspect
import json
import sys
import textwrap
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels import ssd_scan_bwd  # noqa: E402

S, H, P, G, N, CHUNK = 1024, 80, 64, 1, 128, 128
GRADS = ("dx", "ddt", "dA", "dB", "dC")


def _swap(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise SystemExit(f"anchor found {src.count(old)} times, not once, "
                         f"in ssd_bwd_plain: {old!r}")
    return src.replace(old, new)


def variants() -> dict:
    """The source of ``ssd_bwd_plain`` for each variant."""
    src = textwrap.dedent(inspect.getsource(ssd_scan_bwd.ssd_bwd_plain))
    hd = _swap(src, "(ex(total) * (DH * Hs).sum((-1, -2)))",
               "(ex(total) * (DHf * Hsf).sum((-1, -2)))")
    hd = _swap(hd, "Hs = rnd(torch.stack(states[:nc], dim=1))",
               "Hsf = torch.stack(states[:nc], dim=1); Hs = rnd(Hsf)")
    hd = _swap(hd, "DH = rnd(torch.stack(dhs, dim=1))",
               "DHf = torch.stack(dhs, dim=1); DH = rnd(DHf)")
    cb = ("CB = rnd(torch.einsum(", "CB = (torch.einsum(")
    return {"kernel": src, "hd_fp32": hd, "cb_fp32": _swap(src, *cb),
            "both": _swap(hd, *cb)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=1)
    args = ap.parse_args()
    rng = np.random.default_rng(0)

    def randn(*shape, scale=1.0):
        v = rng.standard_normal(shape).astype(np.float32) * scale
        return torch.from_numpy(v)

    B = args.batch
    x = randn(B, S, H, P, scale=0.5).to(torch.bfloat16)
    dt = torch.nn.functional.softplus(randn(B, S, H))
    A = -torch.exp(randn(H))
    Bm = randn(B, S, G, N, scale=0.3).to(torch.bfloat16)
    Cm = randn(B, S, G, N, scale=0.3).to(torch.bfloat16)
    dy = randn(B, S, H, P).to(torch.bfloat16)
    truth = ssd_scan_bwd.ssd_bwd_plain(x, dt, A, Bm, Cm, dy, chunk=CHUNK)
    out = {}
    for name, src in variants().items():
        env = dict(vars(ssd_scan_bwd))
        exec(src, env)
        got = env["ssd_bwd_plain"](x, dt, A, Bm, Cm, dy, chunk=CHUNK,
                                   dtype=torch.bfloat16)
        out[name] = {g: float((u.float() - w.float()).norm()
                              / w.float().norm())
                     for g, u, w in zip(GRADS, got, truth)}
        print(f"[{name}] " + ", ".join(f"{g} {e:.3e}"
                                       for g, e in out[name].items()),
              flush=True)
    print(json.dumps({"shape": f"B{B} S{S} H{H} P{P} G{G} N{N} chunk "
                      f"{CHUNK}", "relative_l2": out}, allow_nan=False))


if __name__ == "__main__":
    main()
