"""Deterministic synthetic data, generated on the device: every batch is a
pure function of (seed, step), drawn by a ``torch.Generator`` on the device
the batch lands on, so no host-to-device copy of images happens per step.

Two token distributions for the LMs (``token_batch``):
  * ``uniform`` — i.i.d. tokens (throughput work).
  * ``lcg``     — learnable: next = (5·prev + 7) mod V with 5% of the
                  positions replaced uniformly, so a loss can fall.

Whisper's and the VLM's batches also carry ``frames``, the stub audio
frames or image patch embeddings (``stub_frames``).

``prototype_imagenet`` is the ImageNet stand-in of the paper's own arch:
class-conditional Gaussian prototypes + noise + random flips. The draws
differ from the JAX package's threefry draws; the parity tests carry the
reference's batches across instead.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core.label_smoothing import IGNORE


def _generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed % 2 ** 63)


@functools.lru_cache(maxsize=1)
def _prototypes(n_classes: int, size: int, seed: int, device: torch.device):
    """The fixed class prototypes (C,H,H,3) f32: 602 MB at ImageNet size,
    so built once per (config, seed, device) and kept."""
    return torch.randn((n_classes, size, size, 3),
                       generator=_generator(device, seed + 777),
                       device=device)


def prototype_imagenet(cfg, *, batch: int, step: int, seed: int = 0,
                       device, noise: float = 0.35):
    """Class-prototype images: {'images': (B,H,W,3) f32, 'labels': (B,)
    int64} on ``device``."""
    device = torch.device(device)
    C, H = cfg.n_classes, cfg.image_size
    protos = _prototypes(C, H, seed, device)
    gen = _generator(device, seed * 2 ** 32 + int(step))
    labels = torch.randint(0, C, (batch,), generator=gen, device=device)
    imgs = protos[labels] + noise * torch.randn(
        (batch, H, H, 3), generator=gen, device=device)
    flip = torch.rand((batch,), generator=gen, device=device) < 0.5
    imgs = torch.where(flip[:, None, None, None], imgs.flip(2), imgs)
    return {"images": imgs, "labels": labels}


@functools.lru_cache(maxsize=4)
def _lcg_coeffs(V: int, n: int, device: torch.device):
    """(a_t, c_t) with x_t = (a_t·x_0 + c_t) mod V for the recurrence
    x_{t+1} = (5·x_t + 7) mod V, t < n: the whole stream in one pass
    instead of n dependent steps."""
    a, c, rows = 1, 0, []
    for _ in range(n):
        rows.append((a, c))
        a, c = 5 * a % V, (5 * c + 7) % V
    return torch.tensor(rows, dtype=torch.int64, device=device).T


def stub_frames(cfg, *, batch: int, step: int, seed: int = 0, device):
    """The stub frontend's output for whisper and the VLM: (B, n_frames,
    d_model) f32 ``0.02 · N(0, 1)``, from a generator of its own for
    (seed, step), as the JAX package folds 99 into the batch's key."""
    gen = _generator(device, (seed * 2 ** 32 + int(step)) * 128 + 99)
    return 0.02 * torch.randn((batch, cfg.encoder.n_frames, cfg.d_model),
                              generator=gen, device=device)


def token_batch(cfg, *, batch: int, seq: int, step: int, seed: int = 0,
                kind: str = "lcg", device):
    """{'tokens': (B,S) int32, 'labels': (B,S) int32} on ``device``:
    labels[t] = tokens[t+1], the last column IGNORE; whisper and the VLM
    add ``frames`` (``stub_frames``)."""
    device = torch.device(device)
    V = cfg.vocab_size
    gen = _generator(device, seed * 2 ** 32 + int(step))
    shape = (batch, seq + 1)
    if kind == "uniform":
        stream = torch.randint(0, V, shape, generator=gen, device=device)
    elif kind == "lcg":
        x0 = torch.randint(0, V, (batch, 1), generator=gen, device=device)
        a, c = _lcg_coeffs(V, seq + 1, device)
        stream = (a * x0 + c) % V
        noise = torch.rand(shape, generator=gen, device=device) < 0.05
        rnd = torch.randint(0, V, shape, generator=gen, device=device)
        stream = torch.where(noise, rnd, stream)
    else:
        raise ValueError(f"unknown token distribution {kind!r}")
    labels = torch.cat([stream[:, 1:seq],
                        torch.full((batch, 1), IGNORE, dtype=stream.dtype,
                                   device=device)], dim=1)
    out = {"tokens": stream[:, :seq].to(torch.int32),
           "labels": labels.to(torch.int32)}
    if cfg.family in ("vlm", "audio"):
        out["frames"] = stub_frames(cfg, batch=batch, step=step, seed=seed,
                                    device=device)
    return out


def make_batch_fn(cfg, shape, *, seed: int = 0, kind: str = "lcg", device,
                  mesh=None, axes=None):
    """step -> batch function for the training loop: prototype-ImageNet
    images for the conv family, ``token_batch`` (``kind``) for the LMs.
    With a ``mesh`` (``launch.mesh``) each rank gets rows
    ``[r·B/n, (r+1)·B/n)`` of the global batch, r its position over the
    mesh's ``axes`` (names; default all of them) in order: the split the
    reference's ``P(axes)`` batch sharding gives (its ``comm='xla'`` step's
    batch lies over every axis but ``model``, its explicit steps' over
    every axis)."""
    B = shape.global_batch
    r, n = 0, 1
    if mesh is not None:
        for a in mesh.axes:
            if axes is None or a.name in axes:
                r, n = r * a.size + a.index, n * a.size
    if B % n:
        raise ValueError(f"global batch {B} does not split over {n} ranks")
    lo, hi = r * B // n, (r + 1) * B // n
    if cfg.family == "conv":
        make = lambda step: prototype_imagenet(cfg, batch=B, step=step,
                                               seed=seed, device=device)
    else:
        make = lambda step: token_batch(cfg, batch=B, seq=shape.seq_len,
                                        step=step, seed=seed, kind=kind,
                                        device=device)

    def batch_fn(step):
        batch = make(step)
        if n == 1:
            return batch
        return {k: v[lo:hi] for k, v in batch.items()}

    return batch_fn
