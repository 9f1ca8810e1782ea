"""Serving example on the PyTorch/CUDA port: batched prefill + autoregressive
decode with KV caches.

The twin of ``examples/serve_decode.py``, on ``repro_torch``: the same
arguments, prompts and printed lines. A batch of prompts goes through the
prefill step (attention in the flash-attention kernel, a hybrid model's
Mamba-2 scan in the ssd_scan kernel), which builds the sized caches, then
tokens are decoded greedily (attention in the decode-attention kernel).
Runs the hybrid (zamba2-family) reduced config by default, to exercise
both KV and SSM state caches and the rotating-window buffer.

On the card the decode step is one CUDA graph replay a token, captured at
the first step: the counterpart of the reference's
``jax.jit(build_decode_step(model), donate_argnums=1)``. The caches are the
graph's own and are updated in place. Runs on the CUDA card (a
capability-9.0 one) unless ``--device cpu`` is given; without a card it
refuses instead of falling back to the CPU.

    PYTHONPATH=src python examples/serve_decode_torch.py --new-tokens 24
    PYTHONPATH=src python examples/serve_decode_torch.py --device cpu
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, reduced
from repro_torch.kernels.common import resolve_device
from repro_torch.models import build_model
from repro_torch.train.train_step import build_decode_step, build_prefill_step


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="zamba2-1.2b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the model runs (cuda needs a capability-9.0 card)")
    return ap


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model, prompts: torch.Tensor, new_tokens: int, max_len: int,
             timings: "dict | None" = None) -> torch.Tensor:
    """Prefill ``prompts`` (B, P) int32, then decode greedily: the first
    token from the prefill's last logits, each next one from a decode step
    at position ``P + t``. Returns the ``new_tokens`` ids (B, new_tokens)
    int32 on the CPU. ``timings``, when given, receives ``prefill_s``,
    ``decode_s`` and ``captured`` (whether decode ran as a CUDA graph)."""
    device = model.device
    prompt_len = prompts.shape[1]
    prefill = build_prefill_step(model, max_len=max_len)
    decode = build_decode_step(model)

    _sync(device)
    t0 = time.perf_counter()
    logits, cache = prefill({"tokens": prompts.to(device)})
    tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
    _sync(device)
    prefill_s = time.perf_counter() - t0

    out = [tok]
    t0 = time.perf_counter()
    for t in range(new_tokens - 1):
        # The graph's logits are a static buffer that the next call
        # overwrites: the argmax is taken before it.
        logits, cache = decode(cache, tok, prompt_len + t)
        tok = logits[:, 0].argmax(-1, keepdim=True).to(torch.int32)
        out.append(tok)
    _sync(device)
    decode_s = time.perf_counter() - t0
    if timings is not None:
        timings.update(prefill_s=prefill_s, decode_s=decode_s, captured=decode.captured)
    return torch.cat(out, dim=1).cpu()


def main(argv=None) -> dict:
    """The example's run; returns ``generate``'s timings with the ``ids``,
    the printed ``tok_s``, the ``model`` and the ``prompts``."""
    ap = build_parser()
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))

    cfg = reduced(ARCHS[args.arch])
    model = build_model(cfg, device=device).init(0)
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32))
    max_len = args.prompt_len + args.new_tokens

    timings: dict = {}
    gen = generate(model, prompts, args.new_tokens, max_len, timings)
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "CPU"
    print(f"prefill: {args.batch} prompts x {args.prompt_len} tokens "
          f"in {timings['prefill_s']:.2f}s")
    dt = timings["decode_s"]
    print(f"decoded {args.new_tokens} tokens/seq in {dt:.2f}s "
          f"({args.new_tokens * args.batch / dt:.1f} tok/s on {where})")
    print("generated token ids (first sequence):", gen[0].tolist())
    return dict(timings, ids=gen, tok_s=args.new_tokens * args.batch / dt, model=model,
                prompts=prompts)


if __name__ == "__main__":
    main()
