"""Mutation check of ``chip_smoke.py``'s K4 backward check (needs a card).

Copies ``chip_smoke.py`` and ``src/`` into ``build/k4_mutant/``, cuts the
``- ε/V`` term from the backward kernel in ``smoothed_xent.cu``, and runs
on that copy: K4 at the LM training path's shape under the old fixed
atol and under ``chip_smoke._dx_close``; ``chip_smoke._xent_case`` at the
path's shape; and ``chip_smoke.check_lm_train_in_context`` at full width.
Exits 0 only if both ``chip_smoke.py`` checks fail the mutant.

    python tools/k4_mutation_check.py
"""
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
COPY = ROOT / "build" / "k4_mutant"
CU = "src/repro_torch/kernels/csrc/smoothed_xent.cu"
TERM = " - eps_over_v);"


def make_copy():
    shutil.rmtree(COPY, ignore_errors=True)
    COPY.mkdir(parents=True)
    shutil.copy(ROOT / "chip_smoke.py", COPY)
    shutil.copytree(ROOT / "src", COPY / "src",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = COPY / CU
    text = cu.read_text()
    if text.count(TERM) != 1:
        sys.exit(f"k4_mutation_check: '{TERM}' not found once in {CU}")
    cu.write_text(text.replace(TERM, ");"))


def old_limit():
    """The mutant at the path's shape under the old and the new limit."""
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import ref
    from repro_torch.kernels import smoothed_xent as sx

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    T, V = cs.XENT_SHAPES[0][1:3]
    x = 4.0 * torch.randn((T, V), generator=gen, device=dev)
    labels = torch.randint(0, V, (T,), generator=gen, device=dev,
                           dtype=torch.int32)
    g = torch.full((T,), 1.0 / T, device=dev)
    _, lse = sx.smoothed_xent_rows_forward(x, labels, 0.1)
    dx = sx.smoothed_xent_rows_backward(x, labels, lse, g, 0.1)
    xp = x.clone().requires_grad_()
    (want,) = torch.autograd.grad(
        ref.smoothed_xent_rows(xp, labels, smoothing=0.1), xp, g)
    rtol, atol = cs.XENT_BWD_TOL["float32"]
    old = bool(((dx - want).abs() <= atol + rtol * want.abs()).all())
    ok, err, per_g = cs._dx_close(dx, want, g, rtol, atol)
    print(f"mutant: old fixed atol passes it: {old}; per-unit-of-g limit "
          f"passes it: {ok} (max abs err {err:.3e}, {per_g:.3e} per unit "
          f"of g)", flush=True)


def kernel():
    import torch
    import chip_smoke as cs
    dev = torch.device("cuda")
    cs._xent_case(dev, torch.Generator(device=dev).manual_seed(3),
                  *cs.XENT_SHAPES[0])


def context():
    import torch
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.data.synthetic import make_batch_fn
    from repro_torch.models.registry import build_model
    from repro_torch.train.state import init_state

    dev = torch.device("cuda")
    cfg = get_config("qwen1.5-0.5b")
    model = build_model(cfg)
    batch_fn = make_batch_fn(cfg, InputShape("train_4k", "train", cs.LM_SEQ,
                                             cs.LM_BATCH), device=dev)
    cs.check_lm_train_in_context(dev, model, init_state(model, seed=0,
                                                        device=dev),
                                 batch_fn(0))


def main():
    if len(sys.argv) > 1:           # one check, run inside the copy
        sys.path[:0] = [str(COPY), str(COPY / "src")]
        {"old_limit": old_limit, "kernel": kernel,
         "context": context}[sys.argv[1]]()
        return
    make_copy()
    for what in ("old_limit", "kernel", "context"):
        run = subprocess.run([sys.executable, __file__, what], cwd=COPY,
                             capture_output=True, text=True)
        print(run.stdout + run.stderr, end="", flush=True)
        print(f"k4_mutation_check {what}: exit {run.returncode}", flush=True)
        if what == "old_limit" and run.returncode != 0:
            sys.exit("k4_mutation_check: the mutant did not run")
        if what != "old_limit" and "chip_smoke: FAILED" not in run.stderr:
            sys.exit(f"k4_mutation_check: chip_smoke.py's {what} check did "
                     f"not fail the mutant")
    print("k4_mutation_check: both checks fail the mutant")


if __name__ == "__main__":
    main()
