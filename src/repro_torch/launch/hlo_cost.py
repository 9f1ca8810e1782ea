"""Structural HLO cost model: walk the call graph, multiply loop bodies.

``compiled.cost_analysis()`` counts each while-loop body ONCE, which
under-reports scanned-layer models by ~num_layers and chunked attention by
~num_chunks. This parser recovers exact totals from ``compiled.as_text()``:

* FLOPs        — every ``dot`` op: 2 x |result| x contraction size
                 (matmuls are >99% of model FLOPs; elementwise ignored);
* bytes        — operand + result bytes at fusion boundaries (top-level ops
                 of each computation; fusion internals are on-chip), an
                 HBM-traffic proxy;
* collectives  — result bytes of all-gather / all-reduce / reduce-scatter /
                 all-to-all / collective-permute, per kind;

all scaled through the call graph: ``while`` bodies multiply by their
``known_trip_count`` (emitted by XLA for lax.scan), fusions/calls by 1,
conditionals by max over branches.
"""

from __future__ import annotations

import math
import re

__all__ = ["hlo_costs"]

_DTYPE_BYTES = {
    "f64": 8, "s64": 8, "u64": 8, "c64": 8, "c128": 16,
    "f32": 4, "s32": 4, "u32": 4,
    "bf16": 2, "f16": 2, "s16": 2, "u16": 2,
    "f8e4m3fn": 1, "f8e5m2": 1, "f8e4m3": 1, "f8e5m2fnuz": 1,
    "s8": 1, "u8": 1, "pred": 1, "s4": 1, "u4": 1,
}

_ARRAY_RE = re.compile(r"(f64|f32|bf16|f16|f8\w*|c64|c128|s64|u64|s32|u32|s16|u16|s8|u8|s4|u4|pred)\[([\d,]*)\]")
_DEF_RE = re.compile(r"^\s*(?:ROOT\s+)?%([\w.\-]+)\s*=\s*(.+)$")
_OP_RE = re.compile(r"^((?:\([^)]*\)|[\w\[\],{}\d.]+)+)\s+([\w\-]+)\((.*)$")
_COMP_HDR_RE = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s+\(.*\)\s*->\s*.+\s*\{\s*$")
_TRIP_RE = re.compile(r'"known_trip_count":\{"n":"(\d+)"\}')
_CALLS_RE = re.compile(r"(?:calls|to_apply|body)=%([\w.\-]+)")
_COND_RE = re.compile(r"condition=%([\w.\-]+)")
_BRANCHES_RE = re.compile(r"branch_computations=\{([^}]*)\}")
_TF_RE = re.compile(r"(?:true_computation|false_computation)=%([\w.\-]+)")
_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")


def _shape_bytes(type_str: str) -> int:
    total = 0
    for m in _ARRAY_RE.finditer(type_str):
        dt, dims = m.group(1), m.group(2)
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES.get(dt, 4)
    return total


def _result_dims(type_str: str) -> tuple[list[int], str] | None:
    m = _ARRAY_RE.search(type_str)
    if not m:
        return None
    dims = [int(d) for d in m.group(2).split(",")] if m.group(2) else []
    return dims, m.group(1)


def _split_computations(text: str) -> dict[str, list[str]]:
    comps: dict[str, list[str]] = {}
    cur, body = None, []
    for line in text.splitlines():
        if cur is None:
            m = _COMP_HDR_RE.match(line.strip())
            if m and ("->" in line):
                cur = m.group(1)
                body = []
        else:
            if line.strip() == "}":
                comps[cur] = body
                cur = None
            else:
                body.append(line)
    return comps


def _parse_op(line: str):
    """Returns (name, result_type, opcode, rest) or None."""
    m = _DEF_RE.match(line)
    if not m:
        return None
    name, rhs = m.group(1), m.group(2)
    m2 = _OP_RE.match(rhs)
    if not m2:
        return None
    return name, m2.group(1), m2.group(2), m2.group(3)


def _dot_flops(result_type, rest, shapes) -> float:
    rd = _result_dims(result_type)
    if rd is None:
        return 0.0
    out_elems = math.prod(rd[0]) if rd[0] else 1
    mc = re.search(r"lhs_contracting_dims=\{([\d,]*)\}", rest)
    ops = re.findall(r"%([\w.\-]+)", rest.split("),", 1)[0] + ")")
    k = 1
    if mc and ops:
        lhs_shape = shapes.get(ops[0])
        if lhs_shape:
            for d in (mc.group(1).split(",") if mc.group(1) else []):
                di = int(d)
                if di < len(lhs_shape):
                    k *= lhs_shape[di]
    return 2.0 * out_elems * k


def hlo_costs(text: str) -> dict:
    """Whole-module costs with loop multipliers applied."""
    comps = _split_computations(text)

    # Pass 1: per-computation self costs + child edges.
    info: dict[str, dict] = {}
    for cname, lines in comps.items():
        shapes: dict[str, list[int]] = {}
        flops = 0.0
        bytes_ = 0.0
        bytes_dots = 0.0
        coll: dict[str, float] = {}
        children: list[tuple[str, float]] = []
        is_fusion_body = cname.startswith("fused_") or cname.startswith("wrapped_")
        dtypes: dict[str, str] = {}
        src: dict[str, str] = {}  # convert/copy/bitcast -> first operand

        def _resolved_dtype(op_name: str) -> str:
            # Look through convert/copy/bitcast chains: the HBM read happens
            # at the SOURCE dtype (bf16 weights widened to f32 by XLA:CPU,
            # int8 KV caches dequantised before the dot — both fuse into the
            # operand fetch on TPU).
            seen = 0
            while op_name in src and seen < 8:
                op_name = src[op_name]
                seen += 1
            return dtypes.get(op_name, "f32")

        for line in lines:
            parsed = _parse_op(line)
            if parsed is None:
                continue
            name, rtype, opcode, rest = parsed
            rd = _result_dims(rtype)
            shapes[name] = rd[0] if rd else []
            dtypes[name] = rd[1] if rd else "f32"
            if opcode in ("convert", "copy", "bitcast"):
                ops = re.findall(r"%([\w.\-]+)", rest)
                if ops:
                    src[name] = ops[0]
            if opcode == "dot" or opcode == "convolution":
                flops += _dot_flops(rtype, rest, shapes)
                # dot-anchored HBM traffic: lhs + rhs + out (the TPU-
                # realistic proxy — elementwise chains fuse into epilogues)
                b = _shape_bytes(rtype)
                for op_name in re.findall(r"%([\w.\-]+)", rest.split("),", 1)[0] + ")")[:2]:
                    shp = shapes.get(op_name)
                    if shp is not None:
                        n = 1
                        for dd in shp:
                            n *= dd
                        b += n * _DTYPE_BYTES.get(_resolved_dtype(op_name), 4)
                bytes_dots += b
            base = opcode.split("-start")[0]
            if base in _COLLECTIVES:
                b = _shape_bytes(rtype)
                coll[base] = coll.get(base, 0.0) + b
                bytes_dots += b  # collectives read+write HBM too
            # HBM upper bound: result bytes of top-level ops at CPU-backend
            # fusion granularity (finer than TPU -> overestimates)
            if not is_fusion_body and opcode not in ("parameter", "constant", "tuple",
                                                     "get-tuple-element", "bitcast"):
                bytes_ += _shape_bytes(rtype)
            # call edges
            if opcode == "while":
                trip = 1.0
                mt = _TRIP_RE.search(line)
                if mt:
                    trip = float(mt.group(1))
                mb = re.search(r"body=%([\w.\-]+)", line)
                if mb:
                    children.append((mb.group(1), trip))
                mcond = _COND_RE.search(line)
                if mcond:
                    children.append((mcond.group(1), trip + 1))
            elif opcode == "conditional":
                branches = _BRANCHES_RE.search(line)
                names = []
                if branches:
                    names = re.findall(r"%([\w.\-]+)", branches.group(1))
                names += _TF_RE.findall(line)
                # one branch executes; charge the max later via equal weight 1/n
                for n in names:
                    children.append((n, 1.0 / max(len(names), 1)))
            else:
                for cn in _CALLS_RE.findall(line):
                    children.append((cn, 1.0))
        info[cname] = dict(
            flops=flops, bytes=bytes_, bytes_dots=bytes_dots, coll=coll,
            children=children,
        )

    # Pass 2: bottom-up totals (memoised DFS).
    memo: dict[str, dict] = {}

    def total(cname: str, stack=()) -> dict:
        if cname in memo:
            return memo[cname]
        if cname not in info or cname in stack:
            return {"flops": 0.0, "bytes": 0.0, "bytes_dots": 0.0, "coll": {}}
        node = info[cname]
        f, b, bd = node["flops"], node["bytes"], node["bytes_dots"]
        c = dict(node["coll"])
        for child, mult in node["children"]:
            sub = total(child, stack + (cname,))
            f += sub["flops"] * mult
            b += sub["bytes"] * mult
            bd += sub["bytes_dots"] * mult
            for k, v in sub["coll"].items():
                c[k] = c.get(k, 0.0) + v * mult
        res = {"flops": f, "bytes": b, "bytes_dots": bd, "coll": c}
        memo[cname] = res
        return res

    entry = None
    for line in text.splitlines():
        if line.startswith("ENTRY"):
            m = re.search(r"ENTRY\s+%?([\w.\-]+)", line)
            if m:
                entry = m.group(1)
            break
    if entry is None:
        # fall back: the computation not called by anyone
        called = {c for v in info.values() for c, _ in v["children"]}
        candidates = [c for c in info if c not in called]
        entry = candidates[-1] if candidates else next(iter(info))
    out = total(entry)
    out["coll_total"] = float(sum(out["coll"].values()))
    return out
