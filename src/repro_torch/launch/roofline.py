"""Roofline analysis from the dry-run artifacts (assignment deliverable (g)).

For each (arch × shape × mesh) cell:

    compute term    = HLO_FLOPs_per_device / peak_FLOP/s          [s]
    memory term     = HLO_bytes_per_device / HBM_bw               [s]
    collective term = collective_bytes_per_device / link_bw       [s]
                      (global collective bytes / (chips·link_bw) — equal,
                       since per-device bytes are uniform under SPMD)

plus MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D (MoE; fwd-only shapes use
2·N·D), the useful-compute ratio MODEL_FLOPS/HLO_FLOPs, the dominant term,
and the projected roofline fraction
``(MODEL_FLOPS_time) / max(terms)`` — the score §Perf hillclimbs.

Usage: PYTHONPATH=src python -m repro.launch.roofline [--inp artifacts/dryrun.jsonl]

The port's twin: the same terms over the same artifact rows, against an
NVIDIA H100 SXM's rates (``HW``) and the temp bytes the port's dry run
reports (``temp_size_in_bytes``; the reference reads a TPU-adjusted temp).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from ..configs import get_config, get_shape

# NVIDIA H100 SXM5 (NVIDIA H100 Tensor Core GPU data sheet): 989 TFLOP/s
# dense bf16, 3.35 TB/s and 80 GB of HBM3, NVLink 900 GB/s in both
# directions together, so 450 GB/s each way ("ici_bw": the link term).
HW = {"peak_flops": 989e12, "hbm_bw": 3.35e12, "ici_bw": 450e9, "hbm_bytes": 80e9}

__all__ = ["analyze", "load_rows", "main", "HW"]


def load_rows(path: str | Path) -> list[dict]:
    return [json.loads(l) for l in Path(path).read_text().splitlines()]


def _chips(mesh_name: str) -> int:
    n = 1
    for part in mesh_name.split("x"):
        n *= int("".join(c for c in part if c.isdigit()))
    return n


def model_flops(arch: str, shape_name: str) -> float:
    """Global useful FLOPs per step: 6·N_active·D train, 2·N_active·D serve."""
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    tokens = shape.global_batch * 1  # decode: one new token
    return 2.0 * n * tokens


def _advice(dom: str, row: dict, ratio: float) -> str:
    arch, shape = row["arch"], row["shape"]
    if dom == "collective":
        if "moe" in get_config(arch).family:
            return "shard_map all-to-all dispatch / wider EP to cut gather-based dispatch collectives"
        return "reduce TP degree for this model size (use model axis as DP) or overlap grads (bf16 all-reduce)"
    if dom == "memory":
        if row["step_kind"] == "serve_decode":
            return "decode is KV-bandwidth-bound: quantize KV cache (int8) or batch more requests"
        return "increase arithmetic intensity: larger per-device batch or fuse elementwise chains"
    if ratio < 0.5:
        return "compute-bound but >2x padded/remat waste: relax remat policy or fix causal over-compute (Pallas flash kernel)"
    return "compute-bound near useful peak: scale batch or accept"


def analyze(rows: list[dict]) -> list[dict]:
    out = []
    for r in rows:
        if r["status"] != "ok":
            out.append(
                dict(arch=r["arch"], shape=r["shape"], mesh=r["mesh"], status=r["status"])
            )
            continue
        chips = _chips(r["mesh"])
        t_comp = r["flops_per_device"] / HW["peak_flops"]
        if r["step_kind"] == "serve_decode":
            # Decode streams its whole working set (weights + KV cache =
            # the argument bytes) once per token; the dot-anchored proxy
            # over-counts dequant-fused operands across fusion boundaries.
            t_mem = r["memory"]["argument_size_in_bytes"] / HW["hbm_bw"]
        else:
            t_mem = r["bytes_per_device"] / HW["hbm_bw"]
        t_coll = r["collectives"]["total_bytes"] / HW["ici_bw"]
        dom = max(
            ("compute", t_comp), ("memory", t_mem), ("collective", t_coll),
            key=lambda kv: kv[1],
        )[0]
        mf = model_flops(r["arch"], r["shape"])
        mf_dev = mf / chips
        ratio = mf_dev / r["flops_per_device"] if r["flops_per_device"] else 0.0
        t_useful = mf_dev / HW["peak_flops"]
        frac = t_useful / max(t_comp, t_mem, t_coll, 1e-30)
        out.append(
            dict(
                arch=r["arch"],
                shape=r["shape"],
                mesh=r["mesh"],
                status="ok",
                step_kind=r["step_kind"],
                compute_s=t_comp,
                memory_s=t_mem,
                collective_s=t_coll,
                dominant=dom,
                model_flops_global=mf,
                useful_ratio=ratio,
                roofline_fraction=frac,
                temp_gb=r["memory"]["temp_size_in_bytes"] / 1e9,
                args_gb=r["memory"]["argument_size_in_bytes"] / 1e9,
                fits_hbm=(
                    r["memory"]["temp_size_in_bytes"]
                    + r["memory"]["argument_size_in_bytes"]
                )
                <= HW["hbm_bytes"],
                advice=_advice(dom, r, ratio),
            )
        )
    return out


def to_markdown(an: list[dict], mesh_filter: str | None = None) -> str:
    lines = [
        "| arch | shape | mesh | comp s | mem s | coll s | dominant | 6ND/HLO | roofline frac | fits 80GB | next lever |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for a in an:
        if mesh_filter and a.get("mesh") != mesh_filter:
            continue
        if a["status"] != "ok":
            lines.append(
                f"| {a['arch']} | {a['shape']} | {a.get('mesh','-')} | — | — | — | {a['status']} | — | — | — | — |"
            )
            continue
        lines.append(
            f"| {a['arch']} | {a['shape']} | {a['mesh']} "
            f"| {a['compute_s']:.3g} | {a['memory_s']:.3g} | {a['collective_s']:.3g} "
            f"| **{a['dominant']}** | {a['useful_ratio']:.2f} | {a['roofline_fraction']:.3f} "
            f"| {'yes' if a['fits_hbm'] else 'NO'} | {a['advice']} |"
        )
    return "\n".join(lines)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--inp", default="artifacts/dryrun.jsonl")
    ap.add_argument("--out", default="artifacts/roofline.json")
    ap.add_argument("--mesh", default=None)
    args = ap.parse_args()
    rows = load_rows(args.inp)
    an = analyze(rows)
    Path(args.out).write_text(json.dumps(an, indent=1))
    print(to_markdown(an, args.mesh))
    return 0


if __name__ == "__main__":
    sys.exit(main())
