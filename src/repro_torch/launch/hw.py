"""The card's constants for the cost model (``comm/cost.py``) and the
bucket autotuner (``comm/autotune.py``), measured on an NVIDIA H100 by the
functions below, and the measurement itself:

  PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \\
      -m repro_torch.launch.hw            # on the cards: one JSON line

* the link: ``alpha`` (seconds a message) and ``beta`` (bytes/s) of one
  ``comm.primitives`` ring step between two cards: each rank sends a
  message to the next rank of the ring and receives one from the previous
  over NCCL (``dist.batch_isend_irecv``, the exchange every ring schedule
  is built from), timed with CUDA events around a run of steps, so that
  the host's cost of posting a step counts where it paces the card. The
  cost model's form ``alpha + bytes / beta`` is fitted over messages of 4
  KB to 64 MB, each point weighted by its own time (a relative fit, so
  that the small messages set alpha);
* HBM bytes/s: a device copy of 1 GiB (read + written);
* bf16 dense matmul FLOP/s: ``torch.matmul`` of two 8192² bf16 matrices.

The ``pod`` axis gets the same link: one host's four cards have no
inter-host link to measure, so no inter-host figure is assumed.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import time
from typing import Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Hardware:
    """A card and its links, as the cost model reads them."""
    name: str
    link_alpha: float         # s a message between two cards of a host
    link_bw: float            # bytes/s of one message's payload
    pod_alpha: float          # the 'pod' axis's link
    pod_bw: float
    hbm_bw: float             # bytes/s
    peak_flops_bf16: float    # dense matmul FLOP/s


#: Measured by ``main`` on "NVIDIA H100 80GB HBM3, 700.00 W" (nvidia-smi),
#: four cards of one host over NVLink, torch 2.11.0+cu128:
#: - link: the relative fit over 4 KB .. 64 MB has a largest residual of
#:   0.27 (messages up to 4 MB all take 100-153 us: the host's posting of
#:   a ``batch_isend_irecv`` exchange paces them, so alpha is mostly host);
#: - HBM: a 1 GiB device copy; bf16: an 8192^3 ``torch.matmul``.
H100 = Hardware(
    name="NVIDIA H100 80GB HBM3",
    link_alpha=1.151e-4,
    link_bw=1.937e11,
    pod_alpha=1.151e-4,       # no inter-host link on one host: the same
    pod_bw=1.937e11,
    hbm_bw=3.032e12,
    peak_flops_bf16=8.011e14,
)

#: message sizes of the link fit, bytes
LINK_BYTES = tuple(4096 * 4 ** i for i in range(8))      # 4 KB .. 64 MB


def _timer(device):
    """(start, stop) -> seconds between them: CUDA events on the card,
    the host clock after the work on the CPU."""
    if device.type == "cuda":
        def start():
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e

        def stop(e0):
            e1 = torch.cuda.Event(enable_timing=True)
            e1.record()
            e1.synchronize()
            return e0.elapsed_time(e1) / 1e3
        return start, stop
    return time.perf_counter, lambda t0: time.perf_counter() - t0


def fit_alpha_beta(nbytes: Sequence[float], secs: Sequence[float]
                   ) -> Tuple[float, float, float]:
    """Least-squares ``t = alpha + bytes / beta`` in relative terms (each
    row divided by its measured time). Returns (alpha, beta, the largest
    relative residual)."""
    import numpy as np
    x = np.asarray(nbytes, float)
    t = np.asarray(secs, float)
    a = np.stack([1 / t, x / t], 1)
    (alpha, inv_beta), *_ = np.linalg.lstsq(a, np.ones_like(t), rcond=None)
    pred = alpha + inv_beta * x
    return float(alpha), float(1 / inv_beta), \
        float(np.max(np.abs(pred / t - 1)))


def measure_link(axis, device, *, sizes: Sequence[int] = LINK_BYTES,
                 iters: int = 20, repeats: int = 3) -> dict:
    """``comm.primitives._ppermute`` of a bf16 message of each size along
    ``axis`` (every rank of the axis joins): the median over ``repeats``
    of the mean over ``iters`` steps, then the fit. Returns {'alpha',
    'beta', 'residual', 'rows': [(bytes, seconds), ...]}."""
    from repro_torch.comm import primitives as prim
    import torch.distributed as dist
    start, stop = _timer(device)
    rows = []
    for nb in sizes:
        x = torch.ones(nb // 2, dtype=torch.bfloat16, device=device)
        for _ in range(3):
            prim._ppermute(x, axis)
        runs = []
        for _ in range(repeats):
            if axis.group is not None:
                dist.barrier(group=axis.group)
            t0 = start()
            for _ in range(iters):
                prim._ppermute(x, axis)
            runs.append(stop(t0) / iters)
        rows.append((nb, statistics.median(runs)))
    alpha, beta, resid = fit_alpha_beta(*zip(*rows))
    return {"alpha": alpha, "beta": beta, "residual": resid, "rows": rows}


def measure_hbm(device, nbytes: int = 2 ** 30, iters: int = 10) -> float:
    """bytes/s of ``dst.copy_(src)`` (each byte read once, written once)."""
    src = torch.ones(nbytes // 4, dtype=torch.float32, device=device)
    dst = torch.empty_like(src)
    dst.copy_(src)
    start, stop = _timer(device)
    t0 = start()
    for _ in range(iters):
        dst.copy_(src)
    return 2 * nbytes * iters / stop(t0)


def measure_matmul(device, n: int = 8192, iters: int = 10) -> float:
    """FLOP/s of a bf16 ``torch.matmul`` of two n x n matrices."""
    a = torch.randn(n, n, device=device).to(torch.bfloat16)
    b = torch.randn(n, n, device=device).to(torch.bfloat16)
    torch.matmul(a, b)
    start, stop = _timer(device)
    t0 = start()
    for _ in range(iters):
        torch.matmul(a, b)
    return 2 * n ** 3 * iters / stop(t0)


def card_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` of the first card."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else "unknown"


def measure(mesh) -> dict:
    """Every constant of :class:`Hardware` on this rank's card, the link
    along ``mesh``'s data axis."""
    dev = mesh.device
    link = measure_link(mesh.axis("data"), dev)
    return {"card": card_line() if dev.type == "cuda" else "cpu",
            "ranks": mesh.size, "link": link, "hbm_bw": measure_hbm(dev),
            "peak_flops_bf16": measure_matmul(dev)}


def main():
    from repro_torch.launch.mesh import make_local_mesh
    mesh = make_local_mesh()
    try:
        out = measure(mesh)
        if mesh.rank == 0:
            print(json.dumps(out), flush=True)
    finally:
        mesh.destroy()


if __name__ == "__main__":
    main()
