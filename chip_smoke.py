"""Drive the PyTorch port on one NVIDIA GPU, end to end, and check it.

    python3 chip_smoke.py

Phases, each reporting on lines of its own; any failure ends the script
with a non-zero exit and no result line:

1. device  -- require CUDA; print ``nvidia-smi``'s name and power limit.
2. build   -- compile every CUDA kernel of the port from ``src/`` (one
              ``nvcc`` per source, all at once) and print the build time.
3. kernels -- each kernel against its plain PyTorch version on the card, at
              the serving path's shapes and at ragged, windowed and mixed-
              length ones: bf16 inputs, plain version in float32, stated
              tolerance; times of kernel, plain version and
              ``F.scaled_dot_product_attention`` (a yardstick the port never
              calls) with CUDA events, and the least time the card could
              take for the same work.
4. model   -- full-width yi-6b in bf16 (random weights from a seed):
              prefill and 4 decode steps through the kernels against the
              same weights through the plain versions; relative L2 error
              of the logits against a stated bound, argmax agreement.
5. serve   -- the serving entry point at full width,
              ``--jobs yi-6b:8,yi-6b:2 --policy srtf --compare-fifo
              --batch 4 --prompt-len 1024 --tokens-per-block 8``, with the
              kernels' launch counters set to 0 just before and read just
              after; every job must finish and both kernels must have run.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.profiler

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (NVIDIA data sheet): dense bf16 tensor-core rate
# and HBM3 bandwidth.  The kernels take bf16 inputs.
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# Kernel vs plain version: |kernel - plain| <= ATOL + RTOL * |plain|.  The
# kernels round probabilities to bf16 before the PV product (flash) and
# round the output to bf16 (both); bf16 keeps 8 bits, ~0.4% relative per
# rounding, and this is the bf16 tolerance of tests/test_kernels.py.
ATOL = RTOL = 2e-2
# Full-width model, kernels vs plain versions: relative L2 error of each
# logits vector.  Per layer the attention outputs differ by a few bf16
# roundings; 32 layers compound them.
MODEL_REL_L2 = 5e-2

SERVE_ARGS = ["--jobs", "yi-6b:8,yi-6b:2", "--policy", "srtf",
              "--compare-fifo", "--batch", "4", "--prompt-len", "1024",
              "--tokens-per-block", "8"]
B, PROMPT, TOKENS_PER_BLOCK, LONGEST = 4, 1024, 8, 8
MAX_SEQ = PROMPT + LONGEST * TOKENS_PER_BLOCK + 8   # make_serve_job's max_seq
SLEEP_CYCLES = 200_000_000            # device sleep before a timed run


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def wall_ms(fn, iters: int, warmup: int = 1) -> float:
    """Milliseconds per call, calls back to back, as a caller sees them
    (paced by the host when launching costs more than the device work)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def device_ms(fn, iters: int, warmup: int = 3) -> float:
    """Device milliseconds per call, with CUDA events.  The device first
    sleeps (~0.1 s) while the host enqueues every call, so the host's launch
    overhead stays out of the measurement; a run whose enqueueing outlasts
    the sleep would be host-paced and fails the check below."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    sleep_start = torch.cuda.Event(enable_timing=True)
    sleep_start.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    if enqueue_ms >= sleep_start.elapsed_time(start):
        fail(f"timing was paced by the host ({enqueue_ms:.1f} ms to enqueue "
             f"{iters} calls)")
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def sdpa(q, k, v, mask=None, causal=False):
    """F.scaled_dot_product_attention on the port's layout (the yardstick)."""
    import torch.nn.functional as F

    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                          is_causal=causal, enable_gqa=True)


def check_close(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    if got.shape != want.shape or not torch.isfinite(got).all():
        fail(f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)} or "
             f"non-finite output")
    diff = (got.float() - want.float()).abs()
    ok = bool((diff <= ATOL + RTOL * want.float().abs()).all())
    err = float(diff.max())
    print(f"[kernels] {name}: max_abs_err={err:.3e} "
          f"(tol {ATOL} + {RTOL}*|plain|) {'ok' if ok else 'MISMATCH'}",
          flush=True)
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return err


# ------------------------------------------------------------------ phases
def phase_device() -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    print(f"[device] {name}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; {torch.cuda.device_count()} device(s)",
          flush=True)
    return name


def phase_build() -> None:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    secs = time.perf_counter() - t0
    print(f"[build] {len(logs)} kernel sources built in {secs:.1f}s",
          flush=True)
    for name, log in sorted(logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)


def phase_kernels(gen: torch.Generator) -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import (
        decode_attention_cuda,
        decode_attention_plain,
    )
    from repro_torch.kernels.flash_attention import (
        flash_attention_cuda,
        flash_attention_plain,
    )

    dev = torch.device("cuda")

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    H, KV, D = 32, 4, 128
    out = {}

    # -- flash attention (prefill) ---------------------------------------
    flash_cases = [
        # name, B, Sq, Sk, mask, window, q_offset
        ("prefill B4 S1024 causal", B, PROMPT, PROMPT, "causal", 0, 0),
        ("ragged Sq200 Sk333 causal q_offset133", 2, 200, 333, "causal", 0,
         133),
        ("ragged Sq77 Sk150 none", 3, 77, 150, "none", 0, 0),
        ("window S700 w128", 2, 700, 700, "window", 128, 0),
    ]
    errs = []
    for name, b, sq, sk, kind, window, off in flash_cases:
        q, k, v = randn(b, sq, H, D), randn(b, sk, KV, D), randn(b, sk, KV, D)
        kw = dict(mask_kind=kind, window=window, q_offset=off)
        got = flash_attention_cuda(q, k, v, **kw)
        want = flash_attention_plain(q.float(), k.float(), v.float(), **kw)
        torch.cuda.synchronize()
        errs.append(check_close(f"flash_attention {name}", got, want))
    # timing at the serving path's prefill shape
    q, k, v = randn(B, PROMPT, H, D), randn(B, PROMPT, KV, D), \
        randn(B, PROMPT, KV, D)
    mask = ref.causal_mask(PROMPT, PROMPT, 0, dev)
    pairs = int(mask.sum())
    flops = 2.0 * B * H * pairs * (D + D)
    o = torch.empty_like(q)
    b_ms, b_by = bound(flops, nbytes(q, k, v, o))
    ms = device_ms(lambda: flash_attention_cuda(q, k, v), 20)
    call_ms = wall_ms(lambda: flash_attention_cuda(q, k, v), 20)
    plain_ms = device_ms(lambda: flash_attention_plain(q, k, v), 5)
    lib_ms = device_ms(lambda: sdpa(q, k, v, causal=True), 20)
    print(f"[kernels] flash_attention B{B} S{PROMPT} H{H} KV{KV} D{D} causal: "
          f"kernel {ms:.4f} ms on the device ({call_ms:.4f} ms per call back "
          f"to back), plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
          f"{b_ms:.4f} ms ({b_by}; {flops / 1e9:.2f} GFLOP)", flush=True)
    out["flash_attention"] = dict(
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms)

    # -- decode attention -------------------------------------------------
    errs = []
    decode_cases = [
        ("decode B4 mixed lengths", [1, 300, 777, MAX_SEQ]),
        ("decode B4 short lengths", [1, 2, 63, 65]),
    ]
    for name, lens in decode_cases:
        q = randn(B, H, D)
        kc, vc = randn(B, MAX_SEQ, KV, D), randn(B, MAX_SEQ, KV, D)
        length = torch.tensor(lens, dtype=torch.int32, device=dev)
        got = decode_attention_cuda(q, kc, vc, length)
        want = decode_attention_plain(q.float(), kc.float(), vc.float(),
                                      length)
        torch.cuda.synchronize()
        errs.append(check_close(f"decode_attention {name} {lens}", got,
                                want))
    zero = torch.tensor([0, 5, 0, 9], dtype=torch.int32, device=dev)
    z = decode_attention_cuda(q, kc, vc, zero)
    torch.cuda.synchronize()
    if bool(z[0].any()) or bool(z[2].any()):
        fail("decode_attention: length 0 rows are not zero")
    print("[kernels] decode_attention length 0 rows: zeros ok", flush=True)
    # timing at a serving decode step: every row at a mid-run length; eight
    # cache copies in turn so the 50 MB L2 does not hold the K/V reads
    fill = PROMPT + LONGEST * TOKENS_PER_BLOCK // 2
    length = torch.full((B,), fill, dtype=torch.int32, device=dev)
    q = randn(B, H, D)
    caches = [(randn(B, MAX_SEQ, KV, D), randn(B, MAX_SEQ, KV, D))
              for _ in range(8)]
    turn = [0]

    def run(fn):
        kc, vc = caches[turn[0] % len(caches)]
        turn[0] += 1
        return fn(q, kc, vc, length)

    o = torch.empty_like(q)
    kv_bytes = B * fill * KV * (D + D) * 2
    flops = 2.0 * B * H * fill * (D + D)
    b_ms, b_by = bound(flops, kv_bytes + nbytes(q, o, length))
    ms = device_ms(lambda: run(decode_attention_cuda), 100)
    call_ms = wall_ms(lambda: run(decode_attention_cuda), 100)
    plain_ms = device_ms(lambda: run(decode_attention_plain), 20)
    valid = torch.arange(MAX_SEQ, device=dev)[None] < length[:, None]
    amask = valid[:, None, None, :]
    lib_ms = device_ms(lambda: run(lambda q_, k_, v_, _l: sdpa(
        q_[:, None], k_, v_, mask=amask)), 50)
    print(f"[kernels] decode_attention B{B} S{MAX_SEQ} fill {fill} H{H} KV{KV} "
          f"D{D}: kernel {ms:.4f} ms on the device ({call_ms:.4f} ms per call "
          f"back to back), plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, "
          f"bound {b_ms:.4f} ms ({b_by}; {kv_bytes / 1e6:.2f} MB of K/V)",
          flush=True)
    out["decode_attention"] = dict(
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms)
    return out


def phase_model(gen: torch.Generator) -> None:
    from repro_torch.configs import get_arch
    from repro_torch.models import lm

    cfg = get_arch("yi-6b")
    t0 = time.perf_counter()
    params = lm.init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"[model] yi-6b full width ({cfg.n_layers} layers, d "
          f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} KV, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}) initialised in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    prompt = torch.randint(0, cfg.vocab_size, (B, PROMPT), generator=gen,
                           device="cuda")
    steps = torch.randint(0, cfg.vocab_size, (4, B), generator=gen,
                          device="cuda")

    def run(backend):
        logits, caches = lm.prefill(cfg, params, prompt, max_seq=MAX_SEQ,
                                    backend=backend)
        out = [logits.float()]
        lengths = torch.full((B,), PROMPT, dtype=torch.int32, device="cuda")
        for tok in steps:
            logits, caches = lm.decode_step(cfg, params, tok, caches, lengths,
                                            backend=backend)
            out.append(logits.float())
            lengths = lengths + 1
        torch.cuda.synchronize()
        return out

    got, want = run("kernel"), run("ref")
    worst, agree, total = 0.0, 0, 0
    for i, (g, w) in enumerate(zip(got, want)):
        if g.shape != (B, cfg.padded_vocab) or not torch.isfinite(g).all():
            fail(f"model step {i}: logits shape {tuple(g.shape)} or "
                 f"non-finite")
        rel = float(((g - w).norm(dim=-1) / w.norm(dim=-1)).max())
        worst = max(worst, rel)
        agree += int((g.argmax(-1) == w.argmax(-1)).sum())
        total += B
    print(f"[model] prefill + 4 decode steps, kernels vs plain: max relative "
          f"L2 error of logits {worst:.3e} (bound {MODEL_REL_L2}), argmax "
          f"agreement {agree}/{total}", flush=True)
    if not worst < MODEL_REL_L2:
        fail("full-width logits through the kernels disagree with the plain "
             "versions")

    # Where a serving step's time goes: prefill and decode-step wall time
    # (back to back, as the serving loop runs them), then torch.profiler
    # over a few decode steps: device busy time by kind of kernel, and the
    # device's idle share between the first kernel's start and the last
    # one's end.
    weight_bytes = sum(       # every weight but the embedding table
        math.prod(shape) * (4 if "norm" in key else 2)
        for key, (shape, _) in lm.param_shapes(cfg).items()
        if key != "embed/table")
    prefill_ms = wall_ms(lambda: lm.prefill(cfg, params, prompt,
                                            max_seq=MAX_SEQ), 3)
    _, caches = lm.prefill(cfg, params, prompt, max_seq=MAX_SEQ)
    lengths = torch.full((B,), PROMPT, dtype=torch.int32, device="cuda")

    def step():
        lm.decode_step(cfg, params, steps[0], caches, lengths)

    step_ms = wall_ms(step, 10, warmup=2)
    print(f"[model] prefill B{B} S{PROMPT}: {prefill_ms:.3f} ms; decode step "
          f"B{B}: {step_ms:.3f} ms; decode-step bound: {weight_bytes / 1e9:.2f}"
          f" GB of weights / 3.35 TB/s = "
          f"{weight_bytes / PEAK_BYTES * 1e3:.3f} ms", flush=True)
    n_prof = 3
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n_prof):
            step()
        torch.cuda.synchronize()
    kinds = {"attention kernels": 0.0, "matmuls": 0.0, "other": 0.0}
    first, last = math.inf, -math.inf
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = e.name.lower()
        if any(t in name for t in ("flash_fwd_kernel", "decode_split_kernel",
                                   "decode_combine_kernel")):
            kind = "attention kernels"
        elif any(t in name for t in ("gemm", "xmma", "cutlass", "nvjet")):
            kind = "matmuls"
        else:
            kind = "other"
        kinds[kind] += e.time_range.elapsed_us()
        first = min(first, e.time_range.start)
        last = max(last, e.time_range.end)
    busy = sum(kinds.values())
    if busy == 0.0:
        print("[model] profiler recorded no device time: device busy and "
              "idle share not measured", flush=True)
    else:
        parts = ", ".join(f"{k} {v / 1e3 / n_prof:.3f} ms"
                          for k, v in kinds.items())
        print(f"[model] profiled decode step (torch.profiler, {n_prof} "
              f"steps): device busy {busy / 1e3 / n_prof:.3f} ms per step "
              f"({parts}); device idle {1 - busy / (last - first):.1%} of "
              f"the {(last - first) / 1e3 / n_prof:.3f} ms per step between "
              f"first and last kernel", flush=True)
    del params, got, want, caches
    gc.collect()
    torch.cuda.empty_cache()


def phase_serve() -> dict:
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    print(f"[serve] python -m repro_torch.launch.serve {' '.join(SERVE_ARGS)}",
          flush=True)
    ops.reset_launch_counts()
    runs = serve.main(SERVE_ARGS)
    launches = ops.launch_counts()
    print(f"[serve] kernel launches in the serve run: {launches}", flush=True)
    want_blocks = sorted([8, 2])
    for policy, run in runs.items():
        blocks = sorted(r.blocks for r in run["results"])
        if blocks != want_blocks or any(r.cancelled for r in run["results"]):
            fail(f"serve {policy}: jobs finished {blocks} blocks, expected "
                 f"{want_blocks}")
        m = run["metrics"]
        print(f"[serve] {policy}: STP={m.stp:.4f} ANTT={m.antt:.4f} "
              f"fairness={m.fairness:.4f} peak_memory="
              f"{run['peak_bytes'] / 2**30:.2f} GiB, every job finished",
              flush=True)
    if sorted(runs) != ["fifo", "srtf"]:
        fail(f"serve ran {sorted(runs)}, expected srtf and fifo")
    for name, count in launches.items():
        if count <= 0:
            fail(f"serve never launched the {name} kernel")
    return launches


def main() -> None:
    kind = phase_device()
    phase_build()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    stats = phase_kernels(gen)
    phase_model(gen)
    launches = phase_serve()
    sources = {
        "flash_attention": (
            "src/repro_torch/kernels/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention.py:109"),
        "decode_attention": (
            "src/repro_torch/kernels/csrc/decode_attention.cu",
            "src/repro/kernels/decode_attention.py:84"),
    }
    kernels = []
    for name, (source, replaces) in sources.items():
        s = stats[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": s["max_abs_err"], "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": s["bound_by"], "library_ms": s["library_ms"]})
    print(json.dumps({"kernels": kernels}, allow_nan=False), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}, allow_nan=False), flush=True)


if __name__ == "__main__":
    main()
