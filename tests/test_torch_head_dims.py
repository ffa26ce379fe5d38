"""Every head-dim pair the zoo hands to an attention kernel has one, on the
CPU.

For each config of ``ARCHS``, at full width and ``.reduced()``, the
(D, Dv) pairs that its layers give the flash forward (after MLA's
``padded_qk_dim``), the flash backward and decode attention must be in
that wrapper's ``HEAD_DIMS`` and in the ``D == ... && Dv == ...`` dispatch
of its CUDA source, read as text: a pair missing from either would raise
on the card (a CUDA tensor goes to the kernel or raises).  The pairs are
derived from the config; on the reduced configs a CPU run of prefill, a
decode step and one gradient, with the plain versions spied on, must hand
over exactly those pairs.
"""

import re

import pytest
import torch

from repro_torch.configs import ARCHS, get_arch
from repro_torch.configs.shapes import InputShape
from repro_torch.data import pipeline as data
from repro_torch.kernels import _build, ops
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import flash_attention as fwd
from repro_torch.kernels import flash_attention_bwd as bwd
from repro_torch.models import lm
from repro_torch.models.mla import padded_qk_dim
from repro_torch.tree import leaves

WRAPPERS = {"flash_attention": fwd, "flash_attention_bwd": bwd,
            "decode_attention": dec}
# The C entry of each kernel's source, whose dispatch names its pairs.
ENTRIES = {"flash_attention": 'extern "C" int flash_attention_fwd(',
           "flash_attention_bwd": 'extern "C" int flash_attention_bwd(',
           "decode_attention": 'extern "C" int decode_attention_fwd('}
CONFIGS = [(arch, reduced) for arch in sorted(ARCHS)
           for reduced in (False, True)]


def pairs_of(cfg):
    """``{wrapper: {(D, Dv), ...}}`` that ``cfg``'s layers hand over:
    attention (GQA, local, an encoder's and cross attention) at the head
    dim to flash, its backward and decode; MLA at its padded qk dim and
    v dim to flash and its backward (it decodes with plain products)."""
    out = {name: set() for name in WRAPPERS}
    hd = cfg.head_dim_
    for stage in lm.build_plan(cfg):
        for spec in stage.unit:
            if spec.mixer in ("gqa", "local"):
                for name in WRAPPERS:
                    out[name].add((hd, hd))
            elif spec.mixer == "mla":
                m = cfg.mla
                qk = m.qk_nope_dim + m.qk_rope_dim
                pair = (padded_qk_dim(qk, m.v_head_dim), m.v_head_dim)
                out["flash_attention"].add(pair)
                out["flash_attention_bwd"].add(pair)
    return out


def dispatched(name):
    """The (D, Dv) pairs of the C entry's dispatch in ``csrc/<name>.cu``."""
    src = (_build.CSRC / f"{name}.cu").read_text()
    entry = src[src.index(ENTRIES[name]):]
    entry = entry[:entry.index("\n}\n")]
    return {(int(d), int(dv))
            for d, dv in re.findall(r"D == (\d+) && Dv == (\d+)", entry)}


@pytest.mark.parametrize("arch,reduced", CONFIGS, ids=str)
def test_every_pair_of_the_zoo_has_a_kernel(arch, reduced):
    cfg = get_arch(arch).reduced() if reduced else get_arch(arch)
    for name, got in pairs_of(cfg).items():
        assert got <= set(WRAPPERS[name].HEAD_DIMS), (name, got)
        assert got <= dispatched(name), (name, got)


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_head_dims_equal_the_dispatch(name):
    """A pair the wrapper lets through reaches a launch in its source, and
    the source launches no pair the wrapper refuses."""
    assert set(WRAPPERS[name].HEAD_DIMS) == dispatched(name)


def test_reduced_pairs_run_on_whole_boxes():
    """The reduced configs' (32, 32) and (64, 32) run the flash kernels on
    tiles of whole 64-column TMA boxes: both sources round a width under
    one box up to it, as ``flash_attention_bwd.tile_dims`` mirrors."""
    for name in ("flash_attention", "flash_attention_bwd"):
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert re.search(r"constexpr int BOX = 64;", src)
        assert "constexpr int tile_width(int d) { return d < BOX ? BOX : d; }" \
            in src
    assert bwd.BOX == 64
    assert bwd.tile_dims(32, 32) == bwd.tile_dims(64, 32) == (64, 64)
    assert bwd.smem_bytes(32, 32) == bwd.smem_bytes(64, 64)
    for pair in ((128, 64), (192, 128), (256, 256)):
        assert bwd.tile_dims(*pair) == pair


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_reduced_model_hands_over_the_derived_pairs(arch, monkeypatch):
    """A CPU run of the reduced config (prefill of 8 tokens after its
    prefix, one decode step, one gradient of the loss) calls the plain
    version of each wrapper with exactly the pairs :func:`pairs_of`
    derives."""
    seen = {name: set() for name in WRAPPERS}

    def spy(name, fn, pair_of):
        def call(*args, **kwargs):
            seen[name].add(pair_of(*args))
            return fn(*args, **kwargs)
        monkeypatch.setattr(ops, fn.__name__, call)

    spy("flash_attention", ops.flash_attention_plain,
        lambda q, k, v, *_: (q.shape[-1], v.shape[-1]))
    spy("flash_attention_bwd", ops.flash_attention_bwd_plain,
        lambda q, k, v, *_: (q.shape[-1], v.shape[-1]))
    spy("decode_attention", ops.decode_attention_plain,
        lambda q, k, v, *_: (q.shape[-1], v.shape[-1]))

    cfg = get_arch(arch).reduced()
    params = lm.init(cfg, seed=0, device="cpu", dtype=torch.float32)
    prefix, n = cfg.n_patches, 8
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (1, n), generator=gen)
    extra = {}
    if cfg.encoder is not None:
        extra["enc_frames"] = 0.02 * torch.randn(
            (1, cfg.encoder.n_frames, cfg.d_model), generator=gen)
    if prefix:
        extra["patches"] = 0.02 * torch.randn((1, prefix, cfg.d_model),
                                              generator=gen)
    with torch.no_grad():
        _, caches = lm.prefill(cfg, params, tokens, max_seq=prefix + n + 8,
                               dtype=torch.float32, **extra)
        lm.decode_step(cfg, params, tokens[:, 0], caches,
                       torch.full((1,), prefix + n, dtype=torch.int32),
                       dtype=torch.float32)
    tparams = lm.init(cfg, seed=0, device="cpu", dtype=torch.float32,
                      stacked=True)
    ps = [p.requires_grad_() for p in leaves(tparams)]
    batch = data.batch_for_step(cfg, InputShape("t", prefix + 16, 1,
                                                "train"), 0, device="cpu")
    total, _ = lm.loss_fn(cfg, tparams, batch, dtype=torch.float32)
    torch.autograd.grad(total, ps)
    assert seen == pairs_of(cfg)
