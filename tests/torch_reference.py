"""Reference computations of the JAX package for the port's parity tests.

Run as a subprocess (``run(...)``), so that XLA can be told to round at
every bf16 operation: by default XLA's fusions keep bf16 intermediates in
higher precision (``--xla_allow_excess_precision``), and a randomly
initialised reduced ResNet is chaotic enough that such a rounding change
moves its logits by O(1). With the flag off, the jitted reference rounds
where its operations say, as op-by-op JAX and the port do. The results go
to an ``.npz`` of ``kind/path`` keys.

  python tests/torch_reference.py resnet_grads OUT.npz
  python tests/torch_reference.py train_steps OUT.npz
"""
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = dict(base_lr=0.5, warmup_steps=1, total_steps=3, decay="poly2")
BATCH = 8
STEPS = 3
#: the last BN scale of every residual branch. At 1.0 (the initializer's)
#: the random reduced ResNet is chaotic in bf16: one-ulp rounding
#: differences (first at s0b1/bn1, one element in 8192) grow through the
#: depth to O(1) in the logits, and so would any two bf16 implementations.
#: 0.1 damps the branches, as training tends to, so that rounding
#: differences stay near rounding size and the comparison means something.
BN3_SCALE = 0.1


def run(what: str, out: str) -> dict:
    """Run ``what`` in a fresh interpreter; returns the saved arrays as
    nested dicts keyed like the trees."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_allow_excess_precision=false").strip())
    subprocess.run([sys.executable, os.path.abspath(__file__), what, out],
                   env=env, check=True, timeout=600, cwd=ROOT)
    tree: dict = {}
    with np.load(out) as z:
        for key in z.files:
            *parents, last = key.split("/")
            node = tree
            for k in parents:
                node = node.setdefault(k, {})
            node[last] = z[key]
    return tree


def _flat(prefix, tree, out):
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flat(f"{prefix}/{k}", v, out)
    else:
        out[prefix] = np.asarray(tree, np.float32) \
            if str(np.asarray(tree).dtype) == "bfloat16" else np.asarray(tree)
    return out


def _state(prefix, s, out):
    out[f"{prefix}/step"] = np.asarray(s.step)
    for name in ("params", "mom", "bn_state"):
        _flat(f"{prefix}/{name}", getattr(s, name), out)


def _init(cfg, seed=0):
    """Reduced-ResNet params and BN state drawn with numpy from the
    descriptors (the reference's jitted initializer costs a compile here;
    the parity tests only need both packages to see the same values),
    with the residual branches damped (``BN3_SCALE``)."""
    import jax
    from repro.models import resnet
    rng = np.random.default_rng(seed)

    def leaf(pd):
        if pd.init == "normal":
            x = np.clip(rng.standard_normal(pd.shape), -2.0, 2.0)
            return (pd.scale * x).astype(np.float32)
        return np.full(pd.shape, {"zeros": 0.0, "ones": 1.0}[pd.init],
                       np.float32)

    ppd, spd = resnet.resnet_pd(cfg)
    is_pd = lambda x: hasattr(x, "init")
    params = jax.tree.map(leaf, ppd, is_leaf=is_pd)
    for blk in params.values():
        if "bn3" in blk:
            blk["bn3"]["scale"] = np.full_like(blk["bn3"]["scale"], BN3_SCALE)
    return params, jax.tree.map(leaf, spd, is_leaf=is_pd)


def _batch(cfg, step):
    """A prototype-ImageNet batch drawn with numpy: class prototypes +
    noise + random horizontal flips, as ``data/synthetic`` makes them."""
    protos = np.random.default_rng(777).standard_normal(
        (cfg.n_classes, cfg.image_size, cfg.image_size, 3))
    rng = np.random.default_rng(1000 + step)
    labels = rng.integers(0, cfg.n_classes, BATCH)
    imgs = protos[labels] + 0.35 * rng.standard_normal(
        (BATCH,) + protos.shape[1:])
    flip = rng.random(BATCH) < 0.5
    imgs[flip] = imgs[flip, :, ::-1]
    return {"images": imgs.astype(np.float32),
            "labels": labels.astype(np.int32)}


def resnet_grads():
    """Reduced ResNet-50: params, BN state, batch, and the bf16 forward
    (logits, new BN state) with its gradients w.r.t. the bf16 copy."""
    import jax
    from repro.configs import get_config
    from repro.core.label_smoothing import smoothed_xent
    from repro.core.precision import cast_to_compute
    from repro.models import resnet

    cfg = get_config("resnet50").reduced()
    params, bn = _init(cfg)
    batch = _batch(cfg, 0)

    def loss(p, imgs, labels):
        logits, new_bn = resnet.resnet_forward(p, bn, cfg, imgs, train=True)
        return smoothed_xent(logits, labels)[0], (logits, new_bn)

    (_, (logits, new_bn)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(cast_to_compute(params), batch["images"],
                             batch["labels"])
    out = {}
    for name, tree in (("params", params), ("bn", bn), ("batch", batch),
                       ("logits", logits), ("new_bn", new_bn),
                       ("grads", grads)):
        _flat(name, jax.device_get(tree), out)
    return out


def train_steps():
    """Reduced ResNet-50, LARS poly2: for use_kernel 0 and 1, three jitted
    steps of ``make_train_step(comm='xla', mesh=None)`` along the
    reference's own trajectory; each step's input state, batch, output
    state and metrics."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.core import lars
    from repro.core.schedule import ScheduleConfig, make_schedule
    from repro.models.registry import build_model
    from repro.train.state import TrainState
    from repro.train.step import make_train_step

    cfg = get_config("resnet50").reduced()
    model = build_model(cfg)
    sched = make_schedule(ScheduleConfig(**LR))
    params, bn = _init(cfg)
    s0 = TrainState(jnp.zeros((), jnp.int32), params,
                    jax.tree.map(np.zeros_like, params), bn)
    out = {}
    for kernel in (0, 1):
        step = jax.jit(make_train_step(
            model, lars.OptConfig(use_kernel=bool(kernel)), sched,
            mesh=None, comm="xla"))
        s = s0
        for k in range(STEPS):
            batch = _batch(cfg, k)
            s2, m = step(s, batch)
            pre = f"k{kernel}/s{k}"
            _state(f"{pre}/in", jax.device_get(s), out)
            _flat(f"{pre}/batch", batch, out)
            _state(f"{pre}/out", jax.device_get(s2), out)
            _flat(f"{pre}/metrics", jax.device_get(m), out)
            s = s2
    return out


if __name__ == "__main__":
    what, dest = sys.argv[1], sys.argv[2]
    np.savez(dest, **{"resnet_grads": resnet_grads,
                      "train_steps": train_steps}[what]())
