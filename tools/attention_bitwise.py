"""Hold the attention kernels of this tree bitwise to another tree's, on
the card.

    python3 tools/attention_bitwise.py OTHER

OTHER is another tree of the repository (for example the parent commit's,
from an unpacked ``git archive`` in a git-ignored directory).  Its
wrappers (``flash_attention``, ``flash_attention_bwd`` and
``decode_attention``) are imported from ``OTHER/src/repro_torch`` and build
their sources into that tree's git-ignored ``_cuda_build/``.  At every
(D, Dv) pair in both trees' ``HEAD_DIMS``, on the same bf16 inputs: the
flash forward's out and lse (a causal prefill, a ragged window with a
q_offset and no mask at Sq 1), the flash backward's dq, dk and dv on the
forward's out and lse, and decode attention's out (mixed lengths, one of
them 0) must be bitwise equal.  Prints the card's name and power limit,
one line per pair and kernel, and exits non-zero on any difference or
without a GPU.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

# baseline puts the repo root and src/ on sys.path
from baseline import card, import_tree
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import flash_attention as fwd
from repro_torch.kernels import flash_attention_bwd as bwd

# (B, Sq, Sk, H, KV, mask_kind, window, q_offset)
FLASH_SHAPES = [(2, 300, 300, 8, 2, "causal", 0, 0),
                (2, 150, 201, 4, 2, "window", 64, 51),
                (2, 1, 190, 4, 4, "none", 0, 0)]
# (B, S, H, KV, lengths)
DECODE_SHAPES = [(4, 300, 8, 2, [1, 77, 0, 300]), (2, 64, 4, 1, [64, 33])]


def main(argv) -> int:
    if len(argv) != 1 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    card()
    other = {name: import_tree(Path(argv[0]), f"kernels.{name}")
             for name in ("flash_attention", "flash_attention_bwd",
                          "decode_attention")}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    def same(name, pair, got, want):
        eq = all(torch.equal(g, w) for g, w in zip(got, want))
        print(f"{name} {pair}: {'bitwise equal' if eq else 'DIFFERENT'}",
              flush=True)
        return eq

    ok = True
    base_fwd = other["flash_attention"]
    base_bwd = other["flash_attention_bwd"]
    for D, Dv in sorted(set(fwd.HEAD_DIMS) & set(base_fwd.HEAD_DIMS)):
        backward = (D, Dv) in bwd.HEAD_DIMS and \
            (D, Dv) in base_bwd.HEAD_DIMS
        for b, sq, sk, h, kv, kind, window, off in FLASH_SHAPES:
            q, k, v = randn(b, sq, h, D), randn(b, sk, kv, D), \
                randn(b, sk, kv, Dv)
            kw = dict(mask_kind=kind, window=window, q_offset=off)
            got = fwd.flash_attention_cuda(q, k, v, return_lse=True, **kw)
            want = base_fwd.flash_attention_cuda(q, k, v, return_lse=True,
                                                 **kw)
            ok &= same(f"flash_attention {kind} Sq{sq}", (D, Dv), got, want)
            if backward:
                dout = randn(b, sq, h, Dv)
                out, lse = got
                ok &= same(f"flash_attention_bwd {kind} Sq{sq}", (D, Dv),
                           bwd.flash_attention_bwd_cuda(q, k, v, out, dout,
                                                        lse, **kw),
                           base_bwd.flash_attention_bwd_cuda(
                               q, k, v, out, dout, lse, **kw))
    base_dec = other["decode_attention"]
    for D, Dv in sorted(set(dec.HEAD_DIMS) & set(base_dec.HEAD_DIMS)):
        for b, s, h, kv, lens in DECODE_SHAPES:
            q, kc, vc = randn(b, h, D), randn(b, s, kv, D), randn(b, s, kv,
                                                                  Dv)
            length = torch.tensor(lens, dtype=torch.int32, device="cuda")
            ok &= same(f"decode_attention S{s} lengths {lens}", (D, Dv),
                       [dec.decode_attention_cuda(q, kc, vc, length)],
                       [base_dec.decode_attention_cuda(q, kc, vc, length)])
    torch.cuda.synchronize()
    print("every pair both trees take bitwise equal" if ok
          else "DIFFERENCES: see above", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
