"""Roofline analysis from the port's dry-run records
(``benchmarks/roofline_impl.py``, for the NVIDIA H100).

Hardware model, per card (NVIDIA H100 80GB HBM3, SXM5, at its 700 W
limit; the data sheet's dense rates):
  989 TFLOP/s bf16, 3.35 TB/s HBM3, and one link bandwidth per mesh axis.

Mesh axes onto links: ranks fill nodes of 8 cards in order, the cards of
a node joined by NVLink (450 GB/s a direction per card).  An axis's
groups stay inside a node when its stride times its size is at most 8;
then it is charged NVLink, else InfiniBand NDR at 50 GB/s a card (400
Gb/s).  On the (16, 16) ``("data", "model")`` mesh both 16-way axes
cross nodes, as ``pod`` does on (2, 16, 16): every axis is charged
InfiniBand.  :func:`link_bw` applies the rule.

Terms (seconds, per step, per device -- the records count rank 0's local
ops):
  compute    = flops_dev / peak
  memory     = bytes_dev / hbm_bw   (op-level bytes, unfused: an upper
                                     bound on what fused kernels move)
  collective = sum over axes of collective_bytes_axis / link_bw(axis)

The dry-run traces the whole step eagerly, so its totals need no loop
correction (:func:`corrected_totals` reads them as they are; the
reference adds its probes' repeats because XLA counts a loop body once).

MODEL_FLOPS = 6*N*D (train) / 2*N*D (prefill/decode), N = active params,
D = tokens processed; the ratio MODEL/traced exposes remat and redundant
work.  ``mfu_proxy`` = model-flops time / max(term).
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import List, Optional

PEAK_FLOPS = 989e12          # bf16 dense / card
HBM_BW = 3.35e12             # bytes/s / card
NVLINK_BW = 450e9            # bytes/s / card, one direction
IB_BW = 50e9                 # bytes/s / card (InfiniBand NDR, 400 Gb/s)
CARDS_PER_NODE = 8

ART_DIR = Path("artifacts/dryrun_torch")


def link_bw(stride: int, size: int) -> float:
    """The link a collective over a mesh axis runs on (ranks ``stride``
    apart, ``size`` of them): NVLink inside one node, InfiniBand across
    nodes."""
    return NVLINK_BW if stride * size <= CARDS_PER_NODE else IB_BW


def _live_bytes(ma: dict) -> int:
    """Peak live bytes per device: the arguments plus the trace's peak."""
    return ma.get("peak_bytes", 0)


def load_cells(mesh: str = "pod16x16") -> List[dict]:
    d = ART_DIR / mesh
    if not d.exists():
        return []
    return [json.loads(p.read_text()) for p in sorted(d.glob("*.json"))]


def corrected_totals(rec: dict) -> Optional[dict]:
    """The step's totals per device: flops, bytes and collective bytes
    (the whole step, as traced), and the collective seconds over the
    axes' links."""
    if rec.get("status") != "ok" or "cost_analysis" not in rec:
        return None
    shape = rec.get("mesh_shape", [16, 16])
    links = {axis: link_bw(math.prod(shape[i + 1:]), shape[i])
             for i, axis in enumerate(_axes(rec))}
    coll = 0
    coll_s = 0.0
    for axis, kinds in rec.get("collectives_by_axis", {}).items():
        n = sum(v["bytes"] for v in kinds.values())
        coll += n
        coll_s += n / links[axis]
    return {"flops": rec["cost_analysis"].get("flops", 0.0),
            "bytes": rec["cost_analysis"].get("bytes accessed", 0.0),
            "collective_bytes": coll, "collective_s": coll_s}


def _axes(rec: dict) -> tuple:
    return ("pod", "data", "model") if len(rec.get("mesh_shape", ())) == 3 \
        else ("data", "model")


def model_flops(rec: dict) -> float:
    """Useful matmul FLOPs for the step (whole job, not per device).

    Encoder-decoder models (whisper) split N between the stacks: the encoder
    sees n_frames tokens, the decoder seq_len tokens.
    """
    from repro_torch.configs import get_arch
    cfg = get_arch(rec["arch"])
    if rec.get("reduced"):
        cfg = cfg.reduced()
    n = rec["n_active_params"]
    B = rec["global_batch"]
    factor = 6.0 if rec["kind"] == "train" else 2.0
    dec_tokens = B * (rec["seq_len"] if rec["kind"] != "decode" else 1)
    if cfg.encoder is None:
        return factor * n * dec_tokens
    enc_frac = cfg.encoder.n_layers / (cfg.encoder.n_layers + cfg.n_layers)
    enc_tokens = B * cfg.encoder.n_frames if rec["kind"] != "decode" else 0
    return factor * n * ((1 - enc_frac) * dec_tokens
                         + enc_frac * enc_tokens)


def analyse(rec: dict, chips: int) -> Optional[dict]:
    tot = corrected_totals(rec)
    if tot is None:
        return None
    compute = tot["flops"] / PEAK_FLOPS
    memory = tot["bytes"] / HBM_BW
    collective = tot["collective_s"]
    terms = {"compute": compute, "memory": memory, "collective": collective}
    dominant = max(terms, key=terms.get)
    mf = model_flops(rec) / chips
    model_time = mf / PEAK_FLOPS
    bound = max(terms.values())
    out = {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "kind": rec["kind"],
        "compute_s": compute, "memory_s": memory, "collective_s": collective,
        "dominant": dominant,
        "model_flops_dev": mf,
        "useful_ratio": mf / tot["flops"] if tot["flops"] else 0.0,
        "mfu_proxy": model_time / bound if bound > 0 else 0.0,
        "mem_gib_dev": _live_bytes(rec.get("memory_analysis", {})) / 2**30,
    }
    out["advice"] = _advice(out)
    return out


def _advice(row: dict) -> str:
    if row["dominant"] == "collective":
        return ("cut FSDP weight all-gathers (persist TP-sharded weights or "
                "overlap with compute); hierarchical reduce on slow axes")
    if row["dominant"] == "memory":
        if row["kind"] == "decode":
            return ("decode is KV/weight-streaming bound: shrink cache "
                    "reads (MLA/window/quantized KV) or batch more tokens")
        return ("op-level bytes are unfused: fuse softmax/norm chains and "
                "cut fp32 transients and remat recompute")
    if row["useful_ratio"] < 0.5:
        return ("compute-bound but <50% useful: reduce remat recompute and "
                "redundant per-shard compute")
    return "near compute roofline: raise arithmetic intensity or accept"


def run_impl():
    rows = []
    for mesh, chips in (("pod16x16", 256), ("pod2x16x16", 512)):
        cells = load_cells(mesh)
        n_ok = n_skip = 0
        for rec in cells:
            if rec.get("status") == "skipped":
                n_skip += 1
                rows.append((f"roofline.{mesh}.{rec['arch']}.{rec['shape']}",
                             "SKIPPED (" + rec.get("why", "")[:40] + ")"))
                continue
            r = analyse(rec, chips)
            if r is None:
                continue
            n_ok += 1
            rows.append((
                f"roofline.{mesh}.{r['arch']}.{r['shape']}",
                f"comp={r['compute_s']:.3f}s;mem={r['memory_s']:.3f}s;"
                f"coll={r['collective_s']:.3f}s;dom={r['dominant']};"
                f"useful={r['useful_ratio']:.2f};mfu~{r['mfu_proxy']:.2f}"))
        if cells:
            rows.append((f"roofline.{mesh}.summary",
                         f"ok={n_ok};skipped={n_skip}"))
    if not rows:
        rows.append(("roofline.status", "no dry-run records found"))
    return rows


def full_table(mesh: str = "pod16x16") -> List[dict]:
    chips = 512 if mesh == "pod2x16x16" else 256
    out = []
    for rec in load_cells(mesh):
        if rec.get("status") == "skipped":
            out.append({"arch": rec["arch"], "shape": rec["shape"],
                        "mesh": mesh, "status": "skipped",
                        "why": rec.get("why", "")})
            continue
        r = analyse(rec, chips)
        if r is not None:
            r["status"] = "ok"
            out.append(r)
    return out
