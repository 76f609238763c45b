"""Serving: prefill + single-token decode steps and a batched greedy
generation loop (a port of ``repro.serve.decode``), with a CLI that mirrors
``examples/serve_decode.py``:

  PYTHONPATH=src python -m repro_torch.serve.decode --reduced   # on the card
  PYTHONPATH=src python -m repro_torch.serve.decode --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.serve.decode --flash-attention \\
      --batch 8 --prompt-len 2048 --max-new 32   # full width, K5 prefill

The JAX package jits the prefill and the decode step; the port runs them
eagerly, casts the f32 masters to bf16 once per ``generate`` call, and
updates the KV cache in place.
"""
from __future__ import annotations

import argparse
import dataclasses
import statistics
import time

import torch

from repro_torch.core.precision import cast_to_compute


def make_prefill_step(model, cache_len: int):
    def prefill_step(params, batch):
        logits, cache = model.forward_prefill(params, batch, cache_len)
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_tok[:, None], cache
    return prefill_step


def make_serve_step(model):
    """serve_step(params, cache, token, pos) -> (next_token, logits, cache);
    the cache is updated in place."""
    def serve_step(params, cache, token, pos: int):
        logits, cache = model.forward_decode(params, cache, token, pos)
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_tok[:, None], logits, cache
    return serve_step


class DeviceClock:
    """Marks on the device's clock: CUDA events on a card (nothing waits
    for the device until a time is read), the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def ms(self, a, b) -> float:
        if not self.cuda:
            return (b - a) * 1e3
        b.synchronize()
        return a.elapsed_time(b)


def generate(model, params, batch, *, max_new: int, cache_len: int,
             timings: dict = None):
    """Batched greedy generation: (B, max_new) int32 tokens. ``timings``,
    if given, receives ``prefill_ms`` and ``decode_ms`` (one per decode
    step) on the device's clock."""
    tokens = batch["tokens"]
    prompt_len = tokens.shape[1]
    if cache_len < prompt_len + max_new:
        # the JAX package's dynamic_update_slice would clamp the write and
        # overwrite the cache's last row; the port refuses instead
        raise ValueError(f"cache_len {cache_len} < prompt length "
                         f"{prompt_len} + max_new {max_new}")
    params = cast_to_compute(params)
    prefill = make_prefill_step(model, cache_len)
    step = make_serve_step(model)
    clock = DeviceClock(tokens.device)
    marks = [clock.mark()]
    tok, cache = prefill(params, batch)
    marks.append(clock.mark())
    out = [tok]
    pos = prompt_len
    for _ in range(max_new - 1):
        tok, _, cache = step(params, cache, tok, pos)
        marks.append(clock.mark())
        out.append(tok)
        pos += 1
    if timings is not None:
        ms = [clock.ms(a, b) for a, b in zip(marks, marks[1:])]
        timings["prefill_ms"], timings["decode_ms"] = ms[0], ms[1:]
    return torch.cat(out, dim=1)


def main(argv=None):
    from repro_torch.configs import get_config
    from repro_torch.core import pinit
    from repro_torch.kernels.backend import resolve_device
    from repro_torch.models.registry import build_model

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-sized variant of the same family")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--flash-attention", action="store_true",
                    help="prefill attention through the flash kernel")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card (the run "
                         "fails without one unless --device cpu is given)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.flash_attention:
        cfg = dataclasses.replace(cfg, flash_attention=True)
    dev = resolve_device(args.device)
    model = build_model(cfg)
    params = pinit.materialize(model.param_pd, seed=args.seed, device=dev)
    gen = torch.Generator().manual_seed(args.seed)
    tokens = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen, dtype=torch.int32).to(dev)
    cache_len = args.prompt_len + args.max_new + 8
    timings = {}
    out = generate(model, params, {"tokens": tokens}, max_new=args.max_new,
                   cache_len=cache_len, timings=timings)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    line = (f"arch={args.arch}{' (reduced)' if args.reduced else ''} on "
            f"{where}: generated {tuple(out.shape)} tokens; prefill "
            f"{timings['prefill_ms']:.2f} ms")
    if timings["decode_ms"]:
        med = statistics.median(timings["decode_ms"])
        line += (f", decode {med:.3f} ms a token (median of "
                 f"{len(timings['decode_ms'])} steps), "
                 f"{args.batch * 1e3 / med:.1f} tokens/s")
    print(line, flush=True)
    print("first request's tokens:", out[0].tolist(), flush=True)


if __name__ == "__main__":
    main()
