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
  python tests/torch_reference.py zero1_steps OUT.npz
  python tests/torch_reference.py comm_shards OUT.npz   (4 host devices)

The reference's explicit data-parallel steps fail under jax 0.9.0 before
they compute anything: ``repro/core/compat.py`` passes ``check_rep=`` to
``jax.shard_map``, which now takes ``check_vma=``, and ``jax.make_mesh``
now makes Explicit axes, which the step's sharding constraints reject.
``zero1_steps`` routes around both without touching ``src/repro``: it
replaces ``compat.shard_map`` in its own process with a shim that calls
``jax.shard_map(..., check_vma=False)``, builds an Auto-axis mesh, and
feeds numpy batches (no mesh-bound batch function).
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


def run(what: str, out: str, *, devices: int = 1) -> dict:
    """Run ``what`` in a fresh interpreter (on ``devices`` host devices);
    returns the saved arrays as nested dicts keyed like the trees."""
    flags = os.environ.get("XLA_FLAGS", "") + \
        " --xla_allow_excess_precision=false"
    if devices > 1:
        flags += f" --xla_force_host_platform_device_count={devices}"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"), XLA_FLAGS=flags.strip())
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


#: the ZeRO-1 parity configuration: the reference's own 1-device test
#: (``test_comm.py::test_shard_update_train_step_1_device``) at f32 wire
ZERO1_COMM = dict(strategy="ring", bucket_mb=0.25, wire_dtype="f32",
                  sharding="zero1")
ZERO1_STEPS = 2
#: (overlap, update_kernel) of the reference's runs
ZERO1_CASES = ((1, 1), (0, 0))


def _shard_map_shim():
    """``repro.core.compat.shard_map`` for jax >= 0.7 (see the module
    docstring); replaced in this process only."""
    import jax
    from repro.core import compat

    def shard_map(f, *, mesh, in_specs, out_specs, check_rep=False):
        return jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                             out_specs=out_specs, check_vma=False)
    compat.shard_map = shard_map


def zero1_steps():
    """Reduced ResNet-50, LARS poly2, the ZeRO-1 explicit-DP step on a
    (1, 1) Auto-axis mesh (ring schedule, f32 wire, 0.25 MB buckets, so
    split tensors), for each (overlap, update_kernel) of ``ZERO1_CASES``:
    two jitted steps
    along the reference's own trajectory; each step's input state, batch,
    output state and metrics. ``o{overlap}u{kernel}/s{k}/...``; shards and
    momentum as ``shards/{bucket}``, ``mom/{bucket}``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType, NamedSharding
    from jax.sharding import PartitionSpec as P
    from repro.configs import get_config
    from repro.configs.base import CommConfig
    from repro.core import lars
    from repro.core.schedule import ScheduleConfig, make_schedule
    from repro.models.registry import build_model
    from repro.train import state as st
    from repro.train.step import make_train_step

    _shard_map_shim()
    cfg = get_config("resnet50").reduced()
    model = build_model(cfg)
    sched = make_schedule(ScheduleConfig(**LR))
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    params, bn = _init(cfg)
    out = {}
    # the two corners: a mixed case differs from them only in how the
    # reference reduces (overlap) or updates (Pallas kernel in interpret
    # mode vs jnp), and each configuration costs ~25 s of compile here
    for overlap, kernel in ZERO1_CASES:
        step = make_train_step(
            model, lars.OptConfig(kind="lars"), sched, mesh=mesh,
            comm=CommConfig(overlap=bool(overlap),
                            update_kernel=bool(kernel), **ZERO1_COMM))
        assert step.n_shards == 1 and step.gather_ahead
        plan = step.bucket_plan
        s = st.TrainState(jnp.zeros((), jnp.int32), params,
                          st.init_packed_momentum(plan, 1), bn,
                          st.init_packed_shards(params, plan, 1))
        # placed as the step's outputs are, so step 2 reuses step 1's
        # compile
        s = jax.device_put(s, NamedSharding(mesh, P()))
        jstep = jax.jit(step)
        for k in range(ZERO1_STEPS):
            batch = _batch(cfg, k)
            s2, m = jstep(s, batch)
            pre = f"o{overlap}u{kernel}/s{k}"
            for io, x in (("in", s), ("out", s2)):
                x = jax.device_get(x)
                out[f"{pre}/{io}/step"] = np.asarray(x.step)
                _flat(f"{pre}/{io}/params", x.params, out)
                _flat(f"{pre}/{io}/bn_state", x.bn_state, out)
                for name in ("shards", "mom"):
                    for b, buf in enumerate(getattr(x, name)):
                        out[f"{pre}/{io}/{name}/{b}"] = np.asarray(buf)
            _flat(f"{pre}/batch", batch, out)
            _flat(f"{pre}/metrics", jax.device_get(m), out)
            s = s2
    return out


#: the small tree of the comm tests (``test_comm.py``'s part A tree, with
#: dict keys): at ``COMM_BUCKET_MB`` its head splits across buckets
COMM_TREE = {"conv": (7, 7, 3, 17), "blocks0": {"w": (33, 65), "b": (65,)},
             "blocks1": {"w": (129, 31)}, "head": (200, 99), "scalar": ()}
COMM_BUCKET_MB = 0.02
COMM_RANKS = 4


def comm_tree():
    """COMM_TREE's values, drawn with numpy (f32)."""
    rng = np.random.default_rng(42)

    def draw(t):
        if isinstance(t, dict):
            return {k: draw(v) for k, v in sorted(t.items())}
        return rng.standard_normal(t).astype(np.float32)
    return draw(COMM_TREE)


def comm_shards():
    """On ``COMM_RANKS`` host devices, device r's gradients
    ``tree * (1 + 0.1 r)`` reduced by each schedule's reduce-scatter-
    terminal form (``ddp.reduce_scatter_grads``, f32 wire): the global
    ``(n * c,)`` shard layout of every bucket, row r from device r, as
    ``{strategy}/{bucket}``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType
    from jax.sharding import PartitionSpec as P
    from repro.core import bucketing, ddp

    tree = comm_tree()
    plan = bucketing.make_plan(tree, bucket_mb=COMM_BUCKET_MB)
    mesh = jax.make_mesh((COMM_RANKS,), ("data",),
                         axis_types=(AxisType.Auto,))
    spec = jax.tree.map(lambda _: P(), tree)
    out = {}
    for strategy in ("psum", "ring"):
        def fn(t):
            r = jax.lax.axis_index("data").astype(jnp.float32)
            g = jax.tree.map(lambda x: x * (1.0 + 0.1 * r), t)
            return tuple(ddp.reduce_scatter_grads(
                g, strategy=strategy, axes=("data",), plan=plan,
                comm_dtype=jnp.float32))
        shards = jax.jit(jax.shard_map(
            fn, mesh=mesh, in_specs=(spec,),
            out_specs=tuple(P("data") for _ in range(plan.n_buckets)),
            check_vma=False))(tree)
        for b, x in enumerate(shards):
            out[f"{strategy}/{b}"] = np.asarray(x)
    return out


if __name__ == "__main__":
    what, dest = sys.argv[1], sys.argv[2]
    np.savez(dest, **{"resnet_grads": resnet_grads,
                      "train_steps": train_steps,
                      "zero1_steps": zero1_steps,
                      "comm_shards": comm_shards}[what]())
