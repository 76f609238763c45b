"""Where serving's time goes, on the card.

Drives ``serve.decode.generate`` (full-width qwen1.5-0.5b by default: 8
prompts of 2048 tokens, 32 greedy tokens; ``--flash-attention`` for the
flash kernel in the prefill) and prints one JSON object:

* ``prefill_ms`` and ``decode_ms`` (median and quartiles of the steps) on
  CUDA events, tokens/s, peak memory;
* ``phase_ms``: for the prefill and for one decode step, the device time
  of the model's parts, from CUDA events around each call of them summed
  over the layers: ``embed``, ``attention`` (K5, the chunked path or the
  decode einsums and softmax), ``mlp`` (SwiGLU), ``logits`` (final norm
  and the tied head), and ``rest`` (the step less those: the QKV and
  output projections, rope, the norms, residuals and cache writes);
* ``profile``: from ``torch.profiler`` over one prefill and over the
  decode steps, device time by kernel group and the device's idle share
  (1 - the union of kernel intervals over the window's span).

  PYTHONPATH=src python -m repro_torch.launch.profile_serve --flash-attention
  PYTHONPATH=src python -m repro_torch.launch.profile_serve --reduced \\
      --device cpu --prompt-len 64 --max-new 4   # rehearsal: host clock,
                                                 # no profile
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics

import torch

from repro_torch.configs import get_config
from repro_torch.core import pinit
from repro_torch.core.precision import cast_to_compute
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlpm
from repro_torch.models import transformer as tf
from repro_torch.models.registry import build_model
from repro_torch.launch.profile_step import device_profile, quartiles
from repro_torch.serve.decode import DeviceClock, generate, \
    make_prefill_step, make_serve_step

#: kernel-name substrings -> group, first match wins
GROUPS = (("flash_attention", ("flash_fwd",)),
          ("gemm", ("gemm", "nvjet", "cutlass", "sm90_", "xmma", "cublas",
                    "gemv")),
          ("softmax", ("softmax",)),
          ("reduction", ("reduce",)),
          ("elementwise", ("elementwise", "vectorized", "unrolled")),
          ("copy/cast/index", ("copy", "cat", "memset", "fill", "index")))

#: (module, function name, phase) timed by ``_Phases``
PARTS = ((tf, "_embed", "embed"), (attn, "_attend", "attention"),
         (attn, "decode_attention", "attention"),
         (mlpm, "swiglu_apply", "mlp"), (tf, "_logits", "logits"))


class _Phases:
    """Times the model's parts (``PARTS``) while active: the modules'
    functions are swapped for timed ones and restored on exit."""

    def __init__(self, clock: DeviceClock):
        self.clock, self.spans = clock, []      # (phase, start, end)

    def __enter__(self):
        self.saved = []
        for mod, name, phase in PARTS:
            fn = getattr(mod, name)
            self.saved.append((mod, name, fn))
            setattr(mod, name, self._timed(fn, phase))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)

    def _timed(self, fn, phase):
        def run(*args, **kw):
            a = self.clock.mark()
            out = fn(*args, **kw)
            self.spans.append((phase, a, self.clock.mark()))
            return out
        return run

    def split(self, fn):
        """Run fn; its total and per-phase times, and ``rest``."""
        t0 = self.clock.mark()
        out = fn()
        t1 = self.clock.mark()
        res = {}
        for phase, a, b in self.spans:
            res[phase] = res.get(phase, 0.0) + self.clock.ms(a, b)
        total = self.clock.ms(t0, t1)
        return out, dict(res, total=total, rest=total - sum(res.values()))


def _phases(model, params, batch, cache_len, clock):
    """Phase split of one prefill and of one decode step after it."""
    with _Phases(clock) as ph:
        (logits, cache), prefill = ph.split(
            lambda: model.forward_prefill(params, batch, cache_len))
    tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    pos = batch["tokens"].shape[1]
    with _Phases(clock) as ph:
        _, decode = ph.split(
            lambda: model.forward_decode(params, cache, tok, pos))
    return {"prefill": prefill, "decode_step": decode}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=2048)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--flash-attention", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, flash_attention=args.flash_attention)
    model = build_model(cfg)
    params = pinit.materialize(model.param_pd, seed=args.seed, device=dev)
    gen = torch.Generator().manual_seed(args.seed)
    batch = {"tokens": torch.randint(
        0, cfg.vocab_size, (args.batch, args.prompt_len), generator=gen,
        dtype=torch.int32).to(dev)}
    cache_len = args.prompt_len + args.max_new + 8
    run = lambda **kw: generate(model, params, batch, max_new=args.max_new,
                                cache_len=cache_len, **kw)
    run()                                    # warm-up
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    timings = {}
    run(timings=timings)
    dec = timings["decode_ms"]
    out = {"device": torch.cuda.get_device_name(dev) if cuda else "cpu",
           "arch": cfg.arch_id, "reduced": args.reduced,
           "batch": args.batch, "prompt_len": args.prompt_len,
           "max_new": args.max_new, "flash_attention": cfg.flash_attention,
           "prefill_ms": timings["prefill_ms"],
           "decode_ms": quartiles(dec),
           "decode_tokens_per_s": (args.batch * 1e3 / statistics.median(dec)
                                   if dec else None),
           "peak_mem_gib": (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                            if cuda else None)}
    p16 = cast_to_compute(params)
    out["phase_ms"] = _phases(model, p16, batch, cache_len,
                              DeviceClock(dev))
    if cuda:
        tok, cache = make_prefill_step(model, cache_len)(p16, batch)
        step, n = make_serve_step(model), args.max_new - 1

        def decode_steps():
            t = tok
            for i in range(n):
                t, _, _ = step(p16, cache, t, args.prompt_len + i)

        out["profile"] = {
            "prefill": device_profile(lambda: model.forward_prefill(
                p16, batch, cache_len), dev, 1, GROUPS),
            "decode": device_profile(decode_steps, dev, n, GROUPS)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
