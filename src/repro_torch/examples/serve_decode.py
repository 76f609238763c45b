"""Batched serving example: prefill a prompt batch, then step-decode with
the KV cache. The torch twin of ``examples/serve_decode.py``, for the
architectures the port serves (the dense GQA family: qwen1.5-0.5b,
qwen1.5-32b, qwen3-14b, mistral-nemo-12b; the MoE qwen2-moe-a2.7b; the
MLA MoE deepseek-v2-236b, whose cache is the latent; the hybrid zamba2-7b
and the xLSTM xlstm-125m, whose caches hold recurrent states; whisper-base
and internvl2-2b, whose requests carry stub frames, as the reference's
do).

  PYTHONPATH=src python -m repro_torch.examples.serve_decode \\
      [--arch qwen1.5-0.5b] [--device cpu]
"""
import argparse
import time
from types import SimpleNamespace

import torch

from repro_torch.configs import get_config
from repro_torch.core import pinit
from repro_torch.kernels.backend import resolve_device
from repro_torch.models.registry import build_model
from repro_torch.serve.decode import generate, prefix_len


def setup(arch: str = "qwen1.5-0.5b", batch: int = 4, prompt_len: int = 32,
          max_new: int = 16, device=None):
    """The run's pieces: cfg, model, params (pinit, seed 0), the prompt
    batch (tokens from a ``torch.Generator`` seeded 0; whisper's and the
    VLM's stub frames, 0.02 · N(0, 1), from the same generator, as the
    reference's example draws them) and cache_len (room for the VLM's
    image prefix too)."""
    dev = resolve_device(device)
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    params = pinit.materialize(model.param_pd, 0, dev)
    gen = torch.Generator(dev).manual_seed(0)
    prompt = {"tokens": torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                                      generator=gen, device=dev)}
    if cfg.family in ("vlm", "audio"):
        prompt["frames"] = 0.02 * torch.randn(
            (batch, cfg.encoder.n_frames, cfg.d_model), generator=gen,
            device=dev)
    return SimpleNamespace(cfg=cfg, device=dev, model=model, params=params,
                           batch=prompt, cache_len=prompt_len
                           + prefix_len(cfg) + max_new + 8)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card (the run "
                         "fails without one unless --device cpu is given)")
    args = ap.parse_args(argv)

    run = setup(args.arch, args.batch, args.prompt_len, args.max_new,
                args.device)
    t0 = time.perf_counter()
    out = generate(run.model, run.params, run.batch, max_new=args.max_new,
                   cache_len=run.cache_len)
    out = out.cpu()
    dt = time.perf_counter() - t0
    print(f"arch={args.arch} generated {tuple(out.shape)} tokens "
          f"in {dt:.2f}s ({args.batch * args.max_new / dt:.1f} tok/s "
          f"incl. compile)")
    print("first request's tokens:", out[0].tolist())
    return out


if __name__ == "__main__":
    main()
