"""The split-span cotangent of ``core/ddp.py`` timed on four cards (needs
four cards): full-width qwen1.5-0.5b's ring replicated step (4 MB
buckets: 222 split spans over 14 leaves), with one f32 buffer a split
leaf a backward (``ddp._split_span_out``) and with the whole leaf copied
for every span, in turns over ``ROUNDS`` rounds, each one warm-up step
and two timed steps through ``chip_smoke._lm_ring_run``. Prints each
form's medians and whether the two forms' masters are bit-equal.

    python tools/split_span_timing.py
"""
import os
import socket
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ROUNDS = 2


def per_span_copies(owned, slot, g, reduced, final):
    """The split-span cotangent of the earlier design: a copy of the whole
    leaf for every span."""
    flat = g.float().reshape(-1).clone()
    flat[slot.elem_offset:slot.elem_offset + slot.size] = reduced
    return flat.view(g.shape)


def rank():
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    import chip_smoke as C
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.core import ddp
    from repro_torch.data.synthetic import make_batch_fn
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.registry import build_model
    from repro_torch.train.state import init_state
    from repro_torch.tree import tree_flatten

    mesh = make_local_mesh()
    say = (lambda m: print(m, flush=True)) if mesh.rank == 0 else \
        (lambda m: None)
    cfg = get_config("qwen1.5-0.5b")
    model = build_model(cfg)
    batch_fn = make_batch_fn(cfg, InputShape("train_4k", "train", C.LM_SEQ,
                                             C.LM_BATCH * mesh.size),
                             device=mesh.device, mesh=mesh)
    state0 = init_state(model, 0, device=mesh.device)
    one_buffer = ddp._split_span_out
    medians, masters = {"one buffer": [], "per-span copies": []}, {}
    for _ in range(ROUNDS):
        for name, fn in (("one buffer", one_buffer),
                         ("per-span copies", per_span_copies)):
            ddp._split_span_out = fn
            row, m = C._lm_ring_run(model, mesh, "ring", "replicated", None,
                                    state0, batch_fn, say)
            medians[name].append(row["median_ms"])
            masters[name] = [x for _, x in tree_flatten(m)]
            del m
            torch.cuda.empty_cache()
    ddp._split_span_out = one_buffer
    same = all(torch.equal(a, b) for a, b in zip(*masters.values()))
    say(f"split-span timing: ring replicated step median ms, {ROUNDS} "
        f"rounds in turns: "
        + "; ".join(f"{k} {[round(v, 2) for v in ms]}"
                    for k, ms in medians.items())
        + f"; masters bit-equal: {same}")
    mesh.destroy()
    if not same:
        raise SystemExit(1)


def main():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "4", "--master-addr", "127.0.0.1", "--master-port", str(port),
         str(Path(__file__).resolve()), "--rank"], cwd=ROOT, text=True,
        capture_output=True, timeout=600,
        env=dict(os.environ, OMP_NUM_THREADS="4"))
    for line in out.stdout.splitlines():
        if line.startswith(("split-span", "lm_ring")):
            print(line, flush=True)
    if out.returncode != 0:
        print(out.stderr[-4000:], file=sys.stderr)
    return out.returncode


if __name__ == "__main__":
    if sys.argv[1:] == ["--rank"]:
        rank()
    else:
        sys.exit(main())
