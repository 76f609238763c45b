"""Where serving's time goes, on the card.

Drives ``serve.decode.generate`` (full-width qwen1.5-0.5b by default, or
any ``--arch`` the port serves, zamba2-7b, xlstm-125m, whisper-base and
internvl2-2b among them: 8 prompts of 2048 tokens, 32 greedy tokens;
whisper's and the VLM's with their stub frames (``--prompt-len`` counts
the tokens; the VLM's image prefix comes on top);
``--flash-attention`` for the flash kernel in the prefill;
``--layers N`` cuts the depth to N layers, printed, as ``chip_smoke.py``'s
serve phases cut qwen3-14b and deepseek-v2-236b) on bf16 weights and
prints one JSON object:

* ``prefill_ms`` and ``decode_ms`` (median and quartiles of the steps) on
  CUDA events, tokens/s, peak memory;
* ``phase_ms``: for the prefill and for one decode step, the device time
  of the model's parts, from CUDA events around each call of them summed
  over the layers: ``embed``, ``attention`` (K5, the chunked path or the
  decode einsums and softmax; with MLA the whole block, ``mla_parallel``
  and ``mla_decode``: projections, rope, the latent cache and the absorbed
  decode), ``mlp`` (SwiGLU; a MoE layer's shared
  experts; the hybrid's shared block's; whisper's GELU MLP), ``encoder``
  (whisper's encoder, whole: its attention and MLPs are not counted
  again), ``cross`` (whisper's cross-attention blocks, whole: projections,
  K5 or the decode's einsums, the cross cache), ``moe`` (routing, dispatch, the
  experts and the combine of a MoE layer), ``mamba`` (a Mamba2 block:
  ``mamba_parallel``, ``mamba_decode``), ``mlstm`` and ``slstm`` (the
  xLSTM blocks, parallel form and decode), ``logits`` (final norm and the
  head), and ``rest`` (the step less those: the QKV and output
  projections, rope, the norms, residuals and cache writes);
* ``profile``: from ``torch.profiler`` over one prefill and over the
  decode steps, device time by kernel group and the device's idle share
  (1 - the union of kernel intervals over the window's span).

``--model-parallel M`` under ``torch.distributed.run`` (one rank a card)
serves any config the model axis splits (ROADMAP §1 items 6.2-6.2c, and
6.3's experts and MLA: the MoE decoder's ``moe`` phase then holds its two
all_to_alls a prefill layer, or its local experts' psum a decode step;
MLA's ``attention`` phase its one all-reduce a layer)
over the ``(data=world/M, model=M)`` mesh: each rank's bf16 shards from
``pinit``, each data row's requests ``--batch`` (every model rank the
same), the model axis's collectives in the ``nccl`` group; rank 0 prints
the JSON, with ``allreduce_us``: one all-reduce over ``model`` of a
decode step's (batch, 1, d) bf16 activations, on CUDA events over 100
calls, and ``phase_ms.collectives``: the all-reduce, all-gather and
all-to-all calls of the split prefill and decode step.

  PYTHONPATH=src python -m repro_torch.launch.profile_serve --flash-attention
  PYTHONPATH=src python -m repro_torch.launch.profile_serve --arch \\
      deepseek-v2-236b --layers 4 --flash-attention
  PYTHONPATH=src python -m repro_torch.launch.profile_serve --arch \\
      zamba2-7b --flash-attention      # also --arch xlstm-125m
  PYTHONPATH=src python -m repro_torch.launch.profile_serve --arch \\
      whisper-base --batch 16 --prompt-len 128 --max-new 64 \\
      --flash-attention                # also --arch internvl2-2b
  PYTHONPATH=src python -m repro_torch.launch.profile_serve --reduced \\
      --device cpu --prompt-len 64 --max-new 4   # rehearsal: host clock,
                                                 # no profile
  PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 -m \\
      repro_torch.launch.profile_serve --arch qwen1.5-32b --layers 16 \\
      --model-parallel 4 --flash-attention   # also --arch qwen2-moe-a2.7b
  PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 -m \\
      repro_torch.launch.profile_serve --arch deepseek-v2-236b --layers 8 \\
      --model-parallel 4 --flash-attention
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import statistics

import torch

from repro_torch.configs import get_config
from repro_torch.core import pinit
from repro_torch.core.precision import cast_to_compute
from repro_torch.data.synthetic import stub_frames
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mb
from repro_torch.models import mlp as mlpm
from repro_torch.models import moe as moem
from repro_torch.models import transformer as tf
from repro_torch.models import xlstm as xl
from repro_torch.models.registry import build_model
from repro_torch.launch.profile_step import device_profile, quartiles
from repro_torch.serve.decode import DeviceClock, generate, \
    make_prefill_step, make_serve_step, prefix_len

#: kernel-name substrings -> group, first match wins
GROUPS = (("nccl", ("nccl",)), ("flash_attention", ("flash_fwd",)),
          ("gemm", ("gemm", "nvjet", "cutlass", "sm90_", "xmma", "cublas",
                    "gemv")),
          ("softmax", ("softmax",)),
          ("reduction", ("reduce",)),
          ("elementwise", ("elementwise", "vectorized", "unrolled")),
          ("copy/cast/index", ("copy", "cat", "memset", "fill", "index")))

#: (module, function name, phase) timed by ``_Phases``; a call inside a
#: timed call of the same phase (MLA's ``_attend``), or of an ``OUTER``
#: one, is not timed again
PARTS = ((tf, "_embed", "embed"), (tf, "_whisper_encode", "encoder"),
         (tf, "_cross_attention", "cross"), (attn, "_attend", "attention"),
         (attn, "decode_attention", "attention"),
         (attn, "mla_parallel", "attention"),
         (attn, "mla_decode", "attention"),
         (mlpm, "swiglu_apply", "mlp"), (mlpm, "gelu_mlp_apply", "mlp"),
         (moem, "moe_apply", "moe"),
         (mb, "mamba_parallel", "mamba"), (mb, "mamba_decode", "mamba"),
         (xl, "mlstm_parallel", "mlstm"), (xl, "mlstm_decode", "mlstm"),
         (xl, "slstm_parallel", "slstm"), (xl, "slstm_decode", "slstm"),
         (tf, "_logits", "logits"))
#: phases timed whole: nothing inside them is timed again
OUTER = frozenset({"encoder", "cross"})


class _Phases:
    """Times the model's parts (``PARTS``) while active: the modules'
    functions are swapped for timed ones and restored on exit."""

    def __init__(self, clock: DeviceClock):
        self.clock, self.spans = clock, []      # (phase, start, end)
        self.open = set()                       # phases being timed

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
            if phase in self.open or self.open & OUTER:
                return fn(*args, **kw)
            self.open.add(phase)
            a = self.clock.mark()
            try:
                out = fn(*args, **kw)
            finally:
                self.open.discard(phase)
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


#: the ``torch.distributed`` collectives the model axis issues
COLLECTIVES = ("all_reduce", "all_gather", "all_to_all_single")


@contextlib.contextmanager
def counting_collectives():
    """Within: each call of a ``COLLECTIVES`` function of
    ``torch.distributed`` is counted (yields ``{name: calls}``)."""
    import torch.distributed as dist
    calls = dict.fromkeys(COLLECTIVES, 0)
    real = {name: getattr(dist, name) for name in COLLECTIVES}

    def wrap(name):
        def fn(*a, **kw):
            calls[name] += 1
            return real[name](*a, **kw)
        return fn
    for name in COLLECTIVES:
        setattr(dist, name, wrap(name))
    try:
        yield calls
    finally:
        for name, fn in real.items():
            setattr(dist, name, fn)


def _phases(model, params, batch, cache_len, clock, mesh=None):
    """Phase split of one prefill and of one decode step after it; over a
    ``mesh``, ``collectives``: each one's calls of ``COLLECTIVES``."""
    counting = counting_collectives if mesh is not None \
        else contextlib.nullcontext
    with _Phases(clock) as ph, counting() as pre:
        (logits, cache), prefill = ph.split(
            lambda: model.forward_prefill(params, batch, cache_len, mesh))
    tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    pos = batch["tokens"].shape[1] + prefix_len(model.cfg)
    with _Phases(clock) as ph, counting() as dec:
        _, decode = ph.split(
            lambda: model.forward_decode(params, cache, tok, pos, mesh))
    out = {"prefill": prefill, "decode_step": decode}
    if mesh is not None:
        out["collectives"] = {"prefill": pre, "decode_step": dec}
    return out


def _allreduce_us(x, axis) -> float:
    """One all-reduce of ``x`` over ``axis``, on CUDA events over 100
    calls after 10."""
    import torch.distributed as dist
    for _ in range(10):
        dist.all_reduce(x, group=axis.group)
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(100):
        dist.all_reduce(x, group=axis.group)
    b.record()
    b.synchronize()
    return a.elapsed_time(b) * 10.0


def cut_depth(cfg, layers):
    """``cfg`` with its depth cut to ``layers`` (None: as it is), the cut
    printed; the width stays as it is."""
    if layers is None:
        return cfg
    if not 0 < layers <= cfg.n_layers:
        raise ValueError(f"--layers {layers}: {cfg.arch_id} has "
                         f"{cfg.n_layers} layers")
    print(f"profile_serve: {cfg.arch_id}'s depth cut to {layers} of its "
          f"{cfg.n_layers} layers", flush=True)
    return dataclasses.replace(cfg, n_layers=layers)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=2048)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--flash-attention", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (a measurement "
                         "option: the full width on fewer layers)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None)
    ap.add_argument("--model-parallel", type=int, default=None, metavar="M",
                    help="serve over the (data, model=M) mesh of every "
                         "rank of the job (torch.distributed.run)")
    args = ap.parse_args(argv)

    mesh = None
    if args.model_parallel is not None:
        from repro_torch.launch.mesh import make_local_mesh
        mesh = make_local_mesh(args.model_parallel, device=args.device)
    dev = mesh.device if mesh is not None else resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    full_depth = cfg.n_layers
    cfg = cut_depth(cfg, args.layers)
    cfg = dataclasses.replace(cfg, flash_attention=args.flash_attention)
    model = build_model(cfg)
    # bf16 weights, each leaf cast as it is made (serve.decode's CLI)
    params = pinit.materialize(model.param_pd, seed=args.seed, device=dev,
                               dtype=torch.bfloat16, mesh=mesh)
    gen = torch.Generator().manual_seed(args.seed)
    batch = {"tokens": torch.randint(
        0, cfg.vocab_size, (args.batch, args.prompt_len), generator=gen,
        dtype=torch.int32).to(dev)}
    if cfg.encoder is not None:
        batch["frames"] = stub_frames(cfg, batch=args.batch, step=0,
                                      seed=args.seed, device=dev)
    start = args.prompt_len + prefix_len(cfg)     # the first new token's
    cache_len = start + args.max_new + 8
    run = lambda **kw: generate(model, params, batch, max_new=args.max_new,
                                cache_len=cache_len, mesh=mesh, **kw)
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
           "layers": [cfg.n_layers, full_depth],
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
                              DeviceClock(dev), mesh)
    if mesh is not None:
        out["mesh"] = dict(zip(mesh.axis_names,
                               (a.size for a in mesh.axes)))
        tp = tf.tp_axis(cfg, mesh)
        if cuda and tp is not None:
            out["allreduce_us"] = _allreduce_us(torch.zeros(
                (args.batch, 1, cfg.d_model), dtype=torch.bfloat16,
                device=dev), tp)
    if cuda:
        tok, cache = make_prefill_step(model, cache_len, mesh)(p16, batch)
        step, n = make_serve_step(model, mesh), args.max_new - 1

        def decode_steps():
            t = tok
            for i in range(n):
                t, _, _ = step(p16, cache, t, start + i)

        out["profile"] = {
            "prefill": device_profile(lambda: model.forward_prefill(
                p16, batch, cache_len, mesh), dev, 1, GROUPS),
            "decode": device_profile(decode_steps, dev, n, GROUPS)}
    if mesh is None or mesh.rank == 0:
        print(json.dumps(out), flush=True)
    if mesh is not None:
        mesh.destroy()
    return out


if __name__ == "__main__":
    main()
