"""Deterministic synthetic data, generated on the device: every batch is a
pure function of (seed, step), drawn by a ``torch.Generator`` on the device
the batch lands on, so no host-to-device copy of images happens per step.

``prototype_imagenet`` is the ImageNet stand-in of the paper's own arch:
class-conditional Gaussian prototypes + noise + random flips. The draws
differ from the JAX package's threefry draws; the parity tests carry the
reference's batches across instead. The LM token stream is ROADMAP §1
item 10.
"""
from __future__ import annotations

import functools

import torch


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


def make_batch_fn(cfg, shape, *, seed: int = 0, device, mesh=None):
    """step -> batch function for the training loop (conv family). With a
    ``mesh`` (``launch.mesh``) each rank gets rows ``[r·B/n, (r+1)·B/n)``
    of the global batch, r its position over the mesh's axes in order:
    the split the reference's ``P(axes)`` batch sharding gives."""
    if cfg.family != "conv":
        raise NotImplementedError(
            "token batches for the LM families are ROADMAP §1 item 10")
    B = shape.global_batch
    r, n = 0, 1
    if mesh is not None:
        for a in mesh.axes:
            r, n = r * a.size + a.index, n * a.size
    if B % n:
        raise ValueError(f"global batch {B} does not split over {n} ranks")
    lo, hi = r * B // n, (r + 1) * B // n

    def batch_fn(step):
        batch = prototype_imagenet(cfg, batch=B, step=step, seed=seed,
                                   device=device)
        if n == 1:
            return batch
        return {k: v[lo:hi] for k, v in batch.items()}

    return batch_fn
