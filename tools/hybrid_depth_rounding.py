"""How the hybrid LM's two serving paths part with depth, on the CPU.

zamba2-7b's structure (a shared attention block before each group of 6
Mamba2 layers) at the reduced width (d 256, vocab 512), random weights
from pinit (seed 0), 2 prompts of ``--prompt`` tokens, at each depth of
``--depths``: the prefill's last logits through the flash kernel's plain
version against the chunked attention path, and one decode step against
the full forward's next position, as ``chip_smoke.py``'s serve context
checks compare them; in bf16 (the served path) and in f32 (the params
cast up, ``precision.f32_compute``). Each figure is the largest
difference over the logits' max. In bf16 the two paths round apart in
every block and the differences add up with the depth; in f32 they stay
at the order of f32 sums.

    PYTHONPATH=src python tools/hybrid_depth_rounding.py
"""
import argparse
import contextlib
import dataclasses

import torch

from repro_torch.configs import get_config
from repro_torch.core import pinit, precision
from repro_torch.models import transformer as tf
from repro_torch.tree import tree_map


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def figures(layers: int, prompt: int, dtype) -> tuple:
    """(flash's plain version vs chunked prefill, decode vs full forward)
    at ``layers`` Mamba layers in ``dtype``."""
    cfg = dataclasses.replace(get_config("zamba2-7b").reduced(),
                              n_layers=layers, attn_every=6)
    flash = dataclasses.replace(cfg, flash_attention=True)
    params = tree_map(lambda t: t.to(dtype), pinit.materialize(
        tf.lm_pd(cfg), 0, "cpu"))
    toks = torch.randint(0, cfg.vocab_size, (2, prompt + 1),
                         generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        full, _ = tf.forward_train(params, cfg, {"tokens": toks})
        last, cache = tf.forward_prefill(params, cfg,
                                         {"tokens": toks[:, :prompt]},
                                         prompt + 8)
        last_f, _ = tf.forward_prefill(params, flash,
                                       {"tokens": toks[:, :prompt]},
                                       prompt + 8)
        dl, _ = tf.forward_decode(params, cfg, cache, toks[:, prompt:],
                                  prompt)
    return _rel(last_f, last), _rel(dl[:, 0], full[:, -1])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--depths", type=int, nargs="+",
                    default=[6, 12, 24, 48, 81])
    ap.add_argument("--prompt", type=int, default=128)
    args = ap.parse_args(argv)
    for layers in args.depths:
        row = [f"layers {layers:3d}"]
        for dtype in (torch.bfloat16, torch.float32):
            with (precision.f32_compute() if dtype == torch.float32
                  else contextlib.nullcontext()):
                pf, dec = figures(layers, args.prompt, dtype)
            name = str(dtype).split(".")[-1]
            row.append(f"{name}: flash vs chunked {pf:.3e}, decode vs full "
                       f"{dec:.3e}")
        print("; ".join(row), flush=True)


if __name__ == "__main__":
    main()
