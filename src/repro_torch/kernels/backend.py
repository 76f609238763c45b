"""Device and kernel-build policy shared by every entry point and wrapper.

* ``resolve_device``: entry points run on ``cuda`` unless the caller asks
  for the CPU. Without a card they raise; they never fall back quietly.
* ``load_library``: each ``csrc/<name>.cu`` is compiled at first use by
  ``nvcc`` for ``sm_90a`` into a shared library with a plain C interface,
  loaded with ``ctypes``. The library lives in ``build/repro_torch/`` at
  the root of the checkout, keyed by a hash of the sources, so an edited
  source is rebuilt and an unchanged one is not.

There is no switch between a kernel and its plain version: the wrappers
choose by the tensor's device (CPU tensor: plain PyTorch; CUDA tensor: the
kernel, or an error).
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. ``"cpu"`` (or any explicit device) is taken
    as given; asking for CUDA without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device found; pass device='cpu' (CLI: --device cpu) "
            "to run on the CPU")
    return dev


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin)")
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named ``csrc`` sources (default: all) that have no
    current library yet, one ``nvcc`` per source, all started together.
    Returns seconds spent per source built (empty when all were current)."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    todo = {n: _lib_path(n) for n in names if not _lib_path(n).exists()}
    if not todo:
        return {}
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc, t0, procs = _nvcc(), time.time(), {}
    for name, out in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    times, errors = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        times[name] = time.time() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)   # atomic: another process sees all or none
    if errors:
        raise RuntimeError("\n".join(errors))
    return times


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and load it (once per process)."""
    build([name])
    return ctypes.CDLL(str(_lib_path(name)))


def on_device(dev: torch.device):
    """The device context for a launch on ``dev``: none where ``dev`` is
    already the current device (a switch is host time on every call)."""
    return (contextlib.nullcontext()
            if dev.index == torch.cuda.current_device()
            else torch.cuda.device(dev))


def check_launch(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` returned by a launcher."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")
