"""Serving launcher: batched prefill + greedy decode (``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b --full \
        --batch 8 --prompt-len 1920 --new-tokens 128 --seed 0
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b --full \
        --batch 8 --prompt-len 3584 --new-tokens 512 --seed 0
    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-moe-16b --full \
        --batch 8 --prompt-len 1920 --new-tokens 128 --seed 0
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-350m --full \
        --batch 8 --prompt-len 1792 --new-tokens 257 --seed 0
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llava-next-34b --full \
        --batch 4 --prompt-len 256 --new-tokens 64 --seed 0

Runs on the CUDA card by default (``--device cpu`` for the CPU, where the
attention kernels' plain versions run); a missing or non-Hopper card is an
error, never a silent CPU run. The prompt goes through ``build_prefill_step``
(attention in the flash-attention kernel, a hybrid model's Mamba-2 scan in
the ssd_scan kernel, the K/V sized into a decode cache of ``prompt_len +
new_tokens`` slots), then each new token through ``build_decode_step``
(attention in the decode-attention kernel, the cache and recurrent states
updated in place; a MoE layer routes each token through its experts). On
the card decode is one CUDA graph replay a token, captured at the first
step, the counterpart of the reference's ``jax.jit(..., donate_argnums=1)``;
a line says whether decode was captured and how many device operations
the graph holds.
Tokens are greedy (``argmax``). A hybrid prompt must be at most
``ssm_chunk`` (256) tokens or a multiple of it, and an xLSTM prompt at
most 256 tokens or a multiple of 256 (the mLSTM chunk), the reference's
rules. xLSTM runs no kernel: its cells are plain PyTorch, as the
reference's are jnp.

A ``patch`` arch (llava-next-34b) prefills zero patch embeddings
(``frontend_len`` of them) before the prompt, and its decode positions
start after both. The cache keeps ``prompt_len + new_tokens`` slots, as
the reference's does, so a prefill longer than that (patches included)
leaves only its last positions in a rotating cache: decode then attends
the last ``prompt_len + new_tokens`` positions, not the patches.

``--list-archs`` prints every registered arch with its serving capability
and exits 0; asking to serve an encoder-only arch (hubert-xlarge) exits 1.
Like the reference's, this launcher installs no mesh, so a config with
``moe_impl="a2a"`` serves only under a caller's ``sharding_ctx``.
``--seed`` makes the random prompts and weights reproducible. :func:`serve` is the same run as a function, for callers
that check its output.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config, list_archs, reduced
from ..kernels.common import resolve_device
from ..models import build_model
from ..models.transformer import ATTN_KINDS
from ..train.train_step import build_decode_step, build_prefill_step

__all__ = ["build_parser", "main", "prefill_agreement", "serve"]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs(),
                    help="arch to serve (required unless --list-archs)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0,
                    help="RNG seed for prompts and parameter init")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--list-archs", action="store_true",
                    help="list archs and their serving capability, exit 0")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the model runs (cuda needs a capability-9.0 card)")
    return ap


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _recurrent(model, caches) -> dict:
    """Copies of the recurrent (Mamba-2, mLSTM, sLSTM) cache leaves, keyed
    by segment."""
    return {i: {name: t.clone() for name, t in cache.items()}
            for i, ((kind, _), cache) in enumerate(zip(model.cfg.segments(), caches))
            if kind not in ATTN_KINDS}


def serve(args: argparse.Namespace, *, keep_logits=(), keep_states=()) -> dict:
    """Prefill ``args.batch`` random prompts, then decode greedily.

    Returns ``prompts`` (B, P) and ``tokens`` (B, new_tokens) as CPU int32
    tensors, ``extra`` (the prefill's other inputs: a ``patch`` arch's
    ``patch_embeds`` on the device, else none), ``pos0`` (the position of
    token 0: P, after ``frontend_len`` patches for a ``patch`` arch),
    ``prefill_logits`` (B, V) f32, ``logits`` {t: (B, V) f32} for each
    decode step ``t`` in ``keep_logits`` (step ``t`` reads token ``t`` at
    position ``pos0 + t`` and predicts token t + 1), ``prefill_s``,
    ``decode_s`` (all decode steps), ``decode_tok_s`` and
    ``steady_decode_tok_s`` (steps 2+, None with fewer than two steps),
    ``decode_graph`` (``captured``, and the graph's device operations by
    kind, ``nodes``, when it was), and the ``model``.
    """
    if args.new_tokens < 1 or args.prompt_len < 1 or args.batch < 1:
        raise ValueError("--batch, --prompt-len and --new-tokens must be >= 1")
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not cfg.supports_decode():
        raise ValueError(f"{args.arch} is encoder-only: no autoregressive serving path")
    if not args.full:
        cfg = reduced(cfg)
    model = build_model(cfg, device=device).init(args.seed)
    rng = np.random.default_rng(args.seed)
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32))
    max_len = args.prompt_len + args.new_tokens
    prefill = build_prefill_step(model, max_len=max_len)
    decode = build_decode_step(model)
    params = sum(p.numel() for p in model.parameters())
    print(f"arch={args.arch} params={params:,d} (cfg.param_count() {cfg.param_count():,d}) "
          f"device={device} batch={args.batch} prompt={args.prompt_len} "
          f"new={args.new_tokens}")

    keep, keep_st = set(keep_logits), set(keep_states)
    extra, pos0 = {}, args.prompt_len
    if cfg.frontend == "patch":
        extra["patch_embeds"] = torch.zeros(
            (args.batch, cfg.frontend_len, cfg.frontend_dim),
            dtype=getattr(torch, cfg.compute_dtype), device=device)
        pos0 += cfg.frontend_len
    inputs = {"tokens": prompts.to(device), **extra}
    _sync(device)
    t0 = time.perf_counter()
    logits, cache = prefill(inputs)
    tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
    prefill_logits = logits[:, -1].float()
    _sync(device)
    prefill_s = time.perf_counter() - t0
    print(f"prefill {args.batch}x{args.prompt_len} in {prefill_s:.3f}s")
    out, kept, states = [tok], {}, {}
    t_step1 = None
    _sync(device)
    t0 = time.perf_counter()
    for t in range(args.new_tokens - 1):
        logits, cache = decode(cache, tok, pos0 + t)
        tok = logits[:, 0].argmax(-1, keepdim=True).to(torch.int32)
        out.append(tok)
        if t in keep:  # a copy: a graph's next replay overwrites its logits
            kept[t] = logits[:, 0].to(torch.float32, copy=True)
        if t in keep_st:
            states[t] = _recurrent(model, cache)
        if t == 0:
            _sync(device)
            t_step1 = time.perf_counter()
    _sync(device)
    t_end = time.perf_counter()
    decode_s = t_end - t0
    steps = args.new_tokens - 1
    tokens = torch.cat(out, dim=1).cpu()
    graph = {"captured": decode.captured, "nodes": getattr(decode, "nodes", {})}
    if graph["captured"]:
        print(f"decode: one CUDA graph a step, captured at step 0; it holds "
              f"{graph['nodes'].get('total', 0):,d} device operations ({graph['nodes']})")
    else:
        print(f"decode: eager, op by op, on {device}")
    summary = dict(
        prompts=prompts, tokens=tokens, extra=extra, pos0=pos0,
        prefill_logits=prefill_logits, logits=kept,
        states=states, params=params,
        prefill_s=prefill_s, decode_s=decode_s,
        decode_tok_s=steps * args.batch / decode_s if steps else None,
        steady_decode_tok_s=((steps - 1) * args.batch / (t_end - t_step1)
                             if steps > 1 else None),
        model=model, max_len=max_len, decode_graph=graph,
    )
    if steps:
        print(f"decoded {steps} steps x {args.batch} in {decode_s:.3f}s "
              f"({summary['decode_tok_s']:.1f} tok/s)")
    print("first sequence:", tokens[0].tolist())
    return summary


def _err(got, ref) -> float:
    return float((got.float() - ref.float()).abs().max() / ref.float().abs().max())


def prefill_agreement(summary: dict, steps) -> list[dict]:
    """Hold decode against prefill on one :func:`serve` run.

    For each decode step ``t`` in ``steps`` (kept in ``summary["logits"]``),
    a fresh prefill over the prompt plus tokens 0..t, after the run's
    ``extra`` inputs (a ``patch`` arch's patches), must give, at its last
    position, the logits decode step ``t`` gave. Returns per step the
    scale-normalised max error ``max |decode - prefill| / max |prefill|``
    and the number of rows whose argmax agrees. Where the run kept the
    recurrent states after step ``t`` (``summary["states"]``), the
    prefill's final states must match them too: ``state_err`` holds, per
    block kind and leaf (``mamba2.ssm``, ``mamba2.conv``, ``mlstm.C``,
    ``slstm.m``, ...), the worst of the per-layer scale-normalised errors.
    """
    model = summary["model"]
    device = model.device
    extra = summary.get("extra", {})
    offset = summary.get("pos0", summary["prompts"].shape[1]) - summary["prompts"].shape[1]
    out = []
    for t in steps:
        seq = torch.cat([summary["prompts"], summary["tokens"][:, : t + 1]], dim=1)
        ref, caches = build_prefill_step(model, max_len=offset + seq.shape[1])(
            {"tokens": seq.to(device), **extra})
        ref = ref[:, -1].float()
        got = summary["logits"][t]
        agree = int((got.argmax(-1) == ref.argmax(-1)).sum())
        row = {"step": t, "err": _err(got, ref), "argmax_agree": agree, "rows": got.shape[0]}
        if t in summary.get("states", {}):
            kinds = [kind for kind, _ in model.cfg.segments()]
            worst: dict = {}
            for i, leaves in summary["states"][t].items():
                for name, kept in leaves.items():
                    key = f"{kinds[i]}.{name}"
                    for g, r in zip(kept, caches[i][name]):
                        worst[key] = max(worst.get(key, 0.0), _err(g, r))
            row["state_err"] = worst
        out.append(row)
    return out


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.list_archs:
        # Explicit listing: encoder-only archs are information, not misuse.
        for arch in list_archs():
            kind = "decode" if get_config(arch).supports_decode() else "encoder-only"
            print(f"{arch}: {kind}")
        return 0
    if args.arch is None:
        ap.error("--arch is required unless --list-archs is given")
    if not get_config(args.arch).supports_decode():
        print(f"{args.arch} is encoder-only: no autoregressive serving path")
        return 1
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))
    serve(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
