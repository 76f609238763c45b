"""Step times of two checkouts of the port on the same card(s), in turns:
``launch/profile_step.py`` with the same arguments from checkout A, then
B, then B, then A (``--rounds`` such rounds), so that a drift of the
card over the call touches both alike. Prints one JSON line per run and,
last, a summary: each checkout's step-time medians, the median of them,
and B − A.

  python3 tools/compare_step.py --a build/parent --b . -- --batch 64 \\
      --sharding zero1
  python3 tools/compare_step.py --a build/parent --b . --ranks 4 -- \\
      --batch 256 --comm ring --sharding zero1 --ring-kernel

``--ranks N`` starts each run under ``torch.distributed.run`` with N
processes (one card each); the reading is rank 0's (the lowest rank whose
JSON line came through whole).
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path


def run(root: Path, ranks: int, args, timeout: float) -> dict:
    mod = ["-m", "repro_torch.launch.profile_step", *args]
    cmd = ([sys.executable, "-m", "torch.distributed.run",
            f"--nproc-per-node={ranks}", *mod] if ranks > 1
           else [sys.executable, *mod])
    out = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                         timeout=timeout,
                         env=dict(os.environ, PYTHONPATH=str(root / "src")))
    rows = []
    for ln in out.stdout.splitlines():
        try:        # the ranks' lines may interleave: keep the whole ones
            row = json.loads(ln)
        except ValueError:
            continue
        if isinstance(row, dict) and "step_ms" in row:
            rows.append(row)
    if out.returncode != 0 or not rows:
        raise SystemExit(f"{root}: exit {out.returncode}\n"
                         f"{out.stderr[-3000:]}")
    return min(rows, key=lambda r: r.get("rank", 0))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--a", required=True, help="checkout A (the parent)")
    ap.add_argument("--b", required=True, help="checkout B (the change)")
    ap.add_argument("--ranks", type=int, default=1)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--timeout", type=float, default=600)
    ap.add_argument("args", nargs=argparse.REMAINDER,
                    help="after --: profile_step's arguments")
    a = ap.parse_args()
    args = a.args[1:] if a.args[:1] == ["--"] else a.args
    roots = {"a": Path(a.a).resolve(), "b": Path(a.b).resolve()}
    med = {"a": [], "b": []}
    for _ in range(a.rounds):
        for which in ("a", "b", "b", "a"):
            row = run(roots[which], a.ranks, args, a.timeout)
            med[which].append(row["step_ms"]["median"])
            print(json.dumps({"checkout": which, **row}), flush=True)
    summary = {k: {"step_ms_medians": v, "median": statistics.median(v)}
               for k, v in med.items()}
    summary["b_minus_a_ms"] = summary["b"]["median"] - summary["a"]["median"]
    print(json.dumps({"args": args, "ranks": a.ranks, **summary}),
          flush=True)


if __name__ == "__main__":
    main()
