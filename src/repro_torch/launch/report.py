"""Comm, autotune, sharding and trace tables (a port of the sections of
``repro.launch.report`` that need no dry-run JSON).

  PYTHONPATH=src python -m repro_torch.launch.report --section comm \\
      [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.report --section autotune
  PYTHONPATH=src python -m repro_torch.launch.report --section shard
  PYTHONPATH=src python -m repro_torch.launch.report --section trace \\
      --trace-json trace.json          # a launch.train --trace export

The comm, autotune and shard sections are predictions of the alpha-beta
cost model (``comm/cost.py``, ``comm/autotune.py``) for the reference's
production meshes (:data:`PRODUCTION_DP_AXES`, up to 512 cards), made
with the constants given as ``hw=`` (default ``launch/hw.H100``, measured
on four NVLink H100s of one host). Each section's heading names them: no
row is a measurement. ``roofline``, ``dryrun`` and ``compare`` read
dry-run JSON and are not ported yet (ROADMAP §1 item 11). Like every
entry point of the port, ``main`` runs on the card unless ``--device cpu``
is given, and raises without one; the sections themselves compute on the
host.
"""
from __future__ import annotations

import argparse
import math
import os

from repro_torch.kernels.backend import resolve_device
from repro_torch.launch import hw as hw_mod


def fmt_t(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-4:
        return f"{x*1e6:.1f}µs"
    if x < 0.1:
        return f"{x*1e3:.2f}ms"
    return f"{x:.3f}s"


def fmt_b(x: float) -> str:
    for unit, div in (("TB", 1e12), ("GB", 1e9), ("MB", 1e6), ("KB", 1e3)):
        if x >= div:
            return f"{x/div:.2f}{unit}"
    return f"{x:.0f}B"


PRODUCTION_DP_AXES = {
    # mesh tag -> (gradient all-reduce axes, their sizes); 'model' is TP
    "16x16": (("data",), (16,)),
    "2x16x16": (("pod", "data"), (2, 16)),
}


def constants_note(hw: hw_mod.Hardware) -> str:
    """What a section's heading adds: whose constants priced its rows."""
    return f" — predicted with {hw.name}'s constants, not measured"


def comm_section(payload_bytes: float = None, bucket_mb: float = 4.0, *,
                 meshes=PRODUCTION_DP_AXES, hw: hw_mod.Hardware = None
                 ) -> str:
    """Per-schedule alpha-beta predicted comm time for ``meshes``
    (``comm/cost.py``), fastest first within each mesh. Default payload:
    the ResNet-50 gradient in bf16 (paper §III-C/§IV)."""
    from repro_torch.comm import cost
    from repro_torch.configs import get_config, param_count

    hw = hw or hw_mod.H100
    if payload_bytes is None:
        payload_bytes = param_count(get_config("resnet50")) * 2   # bf16
    n_buckets = max(1, math.ceil(payload_bytes / (bucket_mb * 2 ** 20)))
    rows = [f"### Predicted all-reduce time, {fmt_b(payload_bytes)} "
            f"gradient in {n_buckets} buckets{constants_note(hw)}\n",
            "| mesh | schedule | msgs | wire/dev | predicted t | phases |",
            "|---|---|---|---|---|---|"]
    for tag, (axes, sizes) in meshes.items():
        for r in cost.predict_table(axes, sizes, payload_bytes,
                                    n_buckets=n_buckets,
                                    links=cost.default_links(axes, hw)):
            phases = " + ".join(p.name for p in r.phases) or "—"
            rows.append(f"| {tag} | {r.schedule} | {r.n_messages} "
                        f"| {fmt_b(r.wire_bytes)} | {fmt_t(r.time_s)} "
                        f"| {phases} |")
    return "\n".join(rows)


def autotune_section(arch: str = "resnet50", *, meshes=PRODUCTION_DP_AXES,
                     hw: hw_mod.Hardware = None) -> str:
    """Per-schedule autotuned bucket plan + predicted overlap efficiency
    for ``meshes`` (``comm/autotune.py``). Backward time comes from the
    family-aware FLOPs model at the paper's 320 images a card."""
    from repro_torch.comm import available, cost
    from repro_torch.comm.autotune import CANDIDATES_MB, autotune
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model

    hw = hw or hw_mod.H100
    cfg = get_config(arch)
    model = build_model(cfg)
    rows = [f"### Autotuned bucket plan ({arch} gradients, bf16 wire; "
            f"candidates {', '.join(f'{c:g}' for c in CANDIDATES_MB)} MB)"
            f"{constants_note(hw)}\n",
            "| mesh | schedule | bucket MB | buckets | t_comm | exposed "
            "| overlap eff | t_step |",
            "|---|---|---|---|---|---|---|---|"]
    for tag, (axes, sizes) in meshes.items():
        links = cost.default_links(axes, hw)
        tuned = [autotune(model.param_pd, schedule=s, axes=axes, sizes=sizes,
                          family=cfg.family, links=links, hw=hw)
                 for s in available()]
        best = min(tuned, key=lambda t: (t.sim.t_step_s, t.n_buckets))
        for t in sorted(tuned, key=lambda t: t.sim.t_step_s):
            star = " **<-**" if (t.schedule == best.schedule
                                 and t.bucket_mb == best.bucket_mb) else ""
            rows.append(
                f"| {tag} | {t.schedule} | {t.bucket_mb:g} "
                f"| {t.n_buckets} | {fmt_t(t.sim.t_comm_s)} "
                f"| {fmt_t(t.sim.t_exposed_s)} | {t.sim.overlap_eff:.2f} "
                f"| {fmt_t(t.sim.t_step_s)}{star} |")
    return "\n".join(rows)


def shard_update_section(arch: str = "resnet50", *,
                         meshes=PRODUCTION_DP_AXES,
                         hw: hw_mod.Hardware = None) -> str:
    """Sharding-policy byte/time accounting: per schedule at its autotuned
    bucket size, the replicated timeline (AR(g) + full update) vs
    sharding='zero1' (in-backward RS(g) + update/n + AG(p) at both gather
    issue points) vs sharding='zero2' (replicated forward, no gather; fp32
    step-end write-back AG) vs sharding='zero3' (just-in-time AG in the
    forward; gather='per_group' re-gathers in the backward, 'ahead'
    retains), plus the zero3-vs-zero1 peak-param-memory reduction
    (``comm.cost.param_memory_reduction``, n-independent)."""
    from repro_torch.comm import available, cost as cost_mod
    from repro_torch.comm.autotune import autotune
    from repro_torch.configs import get_config
    from repro_torch.core import bucketing
    from repro_torch.models.registry import build_model

    hw = hw or hw_mod.H100
    cfg = get_config(arch)
    model = build_model(cfg)
    rows = [f"### Sharding-policy accounting ({arch}, bf16 wire): "
            "replicated vs zero1 (RS+update/n+AG) vs zero2 (replicated "
            "fwd, fp32 AG) vs zero3 (AG in forward)"
            f"{constants_note(hw)}\n",
            "| mesh | schedule | bucket MB | replicated | zero1 at_end "
            "| zero1 ahead | zero2 | zero3 per_group | zero3 ahead "
            "| update | peak-mem ↓ |",
            "|---|---|---|---|---|---|---|---|---|---|---|"]
    for tag, (axes, sizes) in meshes.items():
        consts = dict(links=cost_mod.default_links(axes, hw), hw=hw)
        for s in available():
            ar = autotune(model.param_pd, schedule=s, axes=axes,
                          sizes=sizes, family=cfg.family, **consts)
            sh = autotune(model.param_pd, schedule=s, axes=axes,
                          sizes=sizes, family=cfg.family, sharding="zero1",
                          **consts)
            # the alternative policies priced on the SAME plan as the
            # zero1/ahead row, so the t_step deltas are purely the gather
            # issue point / sharding level
            same = dict(schedule=s, axes=axes, sizes=sizes,
                        family=cfg.family, candidates=(sh.bucket_mb,),
                        **consts)
            end = autotune(model.param_pd, sharding="zero1",
                           gather="at_end", **same)
            z2 = autotune(model.param_pd, sharding="zero2",
                          gather="at_end", **same)
            z3 = autotune(model.param_pd, sharding="zero3",
                          gather="per_group", **same)
            z3r = autotune(model.param_pd, sharding="zero3",
                           gather="ahead", **same)
            plan = bucketing.make_plan(model.param_pd,
                                       bucket_mb=sh.bucket_mb)
            red = cost_mod.param_memory_reduction(
                plan, cost_mod.shard_axis_size(axes, sizes)[1])
            rows.append(
                f"| {tag} | {s} | {sh.bucket_mb:g} "
                f"| {fmt_t(ar.sim.t_step_s)} | {fmt_t(end.sim.t_step_s)} "
                f"| {fmt_t(sh.sim.t_step_s)} | {fmt_t(z2.sim.t_step_s)} "
                f"| {fmt_t(z3.sim.t_step_s)} "
                f"| {fmt_t(z3r.sim.t_step_s)} "
                f"| {fmt_t(ar.sim.t_update_s)}→{fmt_t(sh.sim.t_update_s)} "
                f"| {100 * red:.1f}% |")
    return "\n".join(rows)


def trace_section(trace_json: str) -> str:
    """Per-step / per-bucket span table from a ``launch.train --trace``
    Chrome-trace export: one row per (step, span), compute rows first,
    then the bucket comm spans in the order they start — the
    human-readable twin of the chrome://tracing view."""
    from repro_torch.obs import trace as obs_trace

    spans = obs_trace.spans_from_chrome(obs_trace.load_chrome(trace_json))
    steps = sorted({s.step for s in spans if s.step >= 0})
    rows = [f"### Step timeline ({os.path.basename(trace_json)}: "
            f"{len(steps)} steps, {len(spans)} spans)\n",
            "| step | span | cat | start (into step) | duration |",
            "|---|---|---|---|---|"]
    for st in steps:
        in_step = [s for s in spans if s.step == st]
        t_start = min((s.t0 for s in in_step if s.name == "step"),
                      default=min(s.t0 for s in in_step))
        order = {"step": 0, "compute": 1, "comm": 2, "host": 3}
        for s in sorted(in_step,
                        key=lambda s: (order.get(s.cat, 9), s.t0, s.name)):
            rows.append(f"| {st} | {s.name} | {s.cat} "
                        f"| {fmt_t(max(s.t0 - t_start, 0.0))} "
                        f"| {fmt_t(s.dur_s)} |")
    host = [s for s in spans if s.step < 0]
    if host:
        rows.append("\n### Host events (outside step windows)\n")
        rows.append("| span | cat | duration |")
        rows.append("|---|---|---|")
        for s in sorted(host, key=lambda s: s.t0):
            rows.append(f"| {s.name} | {s.cat} | {fmt_t(s.dur_s)} |")
    return "\n".join(rows)


#: the reference's sections that read dry-run JSON: ROADMAP §1 item 11
_NOT_PORTED = ("roofline", "dryrun", "compare")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun/baseline")
    ap.add_argument("--compare", default=None,
                    help="second records dir: emit baseline-vs-optimized")
    ap.add_argument("--section", default="roofline",
                    choices=["roofline", "dryrun", "comm", "autotune",
                             "shard", "trace"])
    ap.add_argument("--trace-json", default="trace.json",
                    help="--section trace input: the Chrome-trace JSON "
                         "written by launch.train --trace")
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card (the run "
                         "fails without one unless --device cpu is given)")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    section = "compare" if args.compare else args.section
    if section in _NOT_PORTED:
        raise NotImplementedError(
            f"--section {section} reads dry-run JSON, which is not ported "
            f"to repro_torch yet (ROADMAP §1 item 11)")
    text = {"comm": comm_section, "autotune": autotune_section,
            "shard": shard_update_section,
            "trace": lambda: trace_section(args.trace_json)}[section]()
    print(text)
    return text


if __name__ == "__main__":
    main()
