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
  python tests/torch_reference.py zero23_steps OUT.npz
  python tests/torch_reference.py comm_shards OUT.npz   (4 host devices)
  python tests/torch_reference.py attention_cases OUT.npz
  python tests/torch_reference.py lm_cases OUT.npz
  python tests/torch_reference.py lm_train_steps OUT.npz
  python tests/torch_reference.py lm_dp_steps OUT.npz
  python tests/torch_reference.py guard_zero1_run OUT.npz
  python tests/torch_reference.py traced_zero1_step OUT.npz

The reference's explicit data-parallel steps fail under jax 0.9.0 before
they compute anything: ``repro/core/compat.py`` passes ``check_rep=`` to
``jax.shard_map``, which now takes ``check_vma=``, and ``jax.make_mesh``
now makes Explicit axes, which the step's sharding constraints reject.
``zero1_steps``, ``zero23_steps``, ``lm_dp_steps``, ``guard_zero1_run``
and ``traced_zero1_step`` route around both without touching
``src/repro``: each replaces ``compat.shard_map`` in its own process with
a shim that calls ``jax.shard_map(..., check_vma=False)``, builds an
Auto-axis mesh, and feeds numpy batches (no mesh-bound batch function).
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
                _zero1_state(f"{pre}/{io}", jax.device_get(x), out)
            _flat(f"{pre}/batch", batch, out)
            _flat(f"{pre}/metrics", jax.device_get(m), out)
            s = s2
    return out


#: the guarded ZeRO-1 run: ``ZERO1_COMM`` with the plain update, a
#: schedule that moves the params on every step, and a NaN batch at step 2
GUARD_LR = dict(base_lr=0.5, warmup_steps=1, total_steps=6, decay="poly2")
GUARD_STEPS = 4
GUARD_FAULTS = "nan@2"


def _zero1_setup(guard=False, tracer=None):
    """The reduced-ResNet ZeRO-1 step of ``ZERO1_COMM`` (plain update) on a
    (1, 1) Auto-axis mesh under the shard_map shim, and its initial state
    from ``_init``: (cfg, step, state)."""
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
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    step = make_train_step(
        build_model(cfg), lars.OptConfig(kind="lars"),
        make_schedule(ScheduleConfig(**GUARD_LR)), mesh=mesh,
        comm=CommConfig(**ZERO1_COMM), guard=guard, tracer=tracer)
    params, bn = _init(cfg)
    plan = step.bucket_plan
    s = st.TrainState(jnp.zeros((), jnp.int32), params,
                      st.init_packed_momentum(plan, 1), bn,
                      st.init_packed_shards(params, plan, 1))
    # placed as the step's outputs are, so step 2 reuses step 1's compile
    return cfg, step, jax.device_put(s, NamedSharding(mesh, P()))


def guard_zero1_run():
    """The guarded ZeRO-1 step through the reference's ``loop.train`` for
    ``GUARD_STEPS`` steps with ``GUARD_FAULTS``: every step call the loop
    made (``call{k}/``: its input state, the batch as the step got it,
    poisoned or not, its output state and metrics; shards and momentum as
    ``shards/{bucket}``, ``mom/{bucket}``), the final masters
    (``masters/...``), the loop's history rows (``history``: step, loss,
    gnorm, skipped, guard_skip) and the names of the events it emitted, in
    order (``events``). The calls are recorded around the loop's own jitted
    step, so the loop runs as it is."""
    import types

    import jax
    from repro.obs import metrics as obs_metrics
    from repro.train import loop
    from repro.train import state as st
    from repro.train.guard import GuardConfig

    cfg, step, s = _zero1_setup(guard=True)
    out, calls = {}, []

    def recording_jit(fn, **kw):
        jitted = jax.jit(fn, **kw)

        def call(*args):
            if len(args) != 3:
                return jitted(*args)
            pre = f"call{len(calls)}"
            calls.append(pre)
            _zero1_state(f"{pre}/in", jax.device_get(args[0]), out)
            _flat(f"{pre}/batch", args[1], out)
            res = jitted(*args)
            _zero1_state(f"{pre}/out", jax.device_get(res[0]), out)
            _flat(f"{pre}/metrics", jax.device_get(res[1]), out)
            return res
        return call

    loop.jax = types.SimpleNamespace(jit=recording_jit,
                                     block_until_ready=jax.block_until_ready)
    sink = obs_metrics.MemorySink()
    with obs_metrics.default_registry().use_sink(sink):
        s, hist = loop.train(s, step, lambda k: _batch(cfg, int(k)),
                             steps=GUARD_STEPS, log_every=1,
                             faults=GUARD_FAULTS, guard=GuardConfig())
    _flat("masters", jax.device_get(st.full_params_from_shards(
        s.shards, step.bucket_plan, 1)), out)
    out["step"] = np.asarray(int(s.step))
    out["calls"] = np.asarray(len(calls))
    out["events"] = np.asarray([e.name for e in sink.events])
    out["history"] = np.asarray(
        [[h["step"], h.get("loss", np.nan), h.get("gnorm", np.nan),
          h.get("skipped", np.nan), "guard_skip" in h] for h in hist],
        np.float64)
    return out


def _zero1_state(prefix, x, out):
    out[f"{prefix}/step"] = np.asarray(x.step)
    _flat(f"{prefix}/params", x.params, out)
    _flat(f"{prefix}/bn_state", x.bn_state, out)
    for name in ("shards", "mom"):
        for b, buf in enumerate(getattr(x, name)):
            out[f"{prefix}/{name}/{b}"] = np.asarray(buf)


def traced_zero1_step():
    """One ZeRO-1 step of ``_zero1_setup`` under the reference's tracer:
    the names and categories of its spans (``spans``)."""
    import jax
    from repro.obs.trace import Tracer

    tracer = Tracer()
    cfg, step, s = _zero1_setup(tracer=tracer)
    tracer.begin_step()
    jax.block_until_ready(jax.jit(step)(s, _batch(cfg, 0)))
    tracer.end_step(0)
    return {"spans": np.asarray([[sp.name, sp.cat]
                                 for sp in tracer.spans(0)])}


#: the zero2 / zero3 parity configurations, in the reference's own 1-device
#: setting (``ZERO1_COMM``'s ring, f32 wire, 0.25 MB buckets):
#: (sharding, gather, overlap, update_kernel) by key
ZERO23_CASES = {"zero2": ("zero2", "at_end", 1, 1),
                "zero3_per_group": ("zero3", "per_group", 1, 0),
                "zero3_ahead": ("zero3", "ahead", 0, 1)}


def zero23_steps():
    """Reduced ResNet-50, LARS poly2, the zero2 and zero3 explicit-DP
    steps on a (1, 1) Auto-axis mesh, for each of ``ZERO23_CASES``: two
    jitted steps along the reference's own trajectory; each step's input
    state (params absent under zero3, shards under zero2), batch, output
    state and metrics, as ``{case}/s{k}/...``."""
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
    comm = {k: v for k, v in ZERO1_COMM.items() if k != "sharding"}
    out = {}
    for case, (sharding, gather, overlap, kernel) in ZERO23_CASES.items():
        step = make_train_step(
            model, lars.OptConfig(kind="lars"), sched, mesh=mesh,
            comm=CommConfig(sharding=sharding, gather=gather,
                            overlap=bool(overlap),
                            update_kernel=bool(kernel), **comm))
        assert step.n_shards == 1 and step.sharding == sharding
        plan = step.bucket_plan
        s = st.TrainState(
            jnp.zeros((), jnp.int32),
            None if sharding == "zero3" else params,
            st.init_packed_momentum(plan, 1), bn,
            None if sharding == "zero2"
            else st.init_packed_shards(params, plan, 1))
        s = jax.device_put(s, NamedSharding(mesh, P()))
        jstep = jax.jit(step)
        for k in range(ZERO1_STEPS):
            batch = _batch(cfg, k)
            s2, m = jstep(s, batch)
            pre = f"{case}/s{k}"
            for io, x in (("in", s), ("out", s2)):
                x = jax.device_get(x)
                out[f"{pre}/{io}/step"] = np.asarray(x.step)
                if x.params is not None:
                    _flat(f"{pre}/{io}/params", x.params, out)
                _flat(f"{pre}/{io}/bn_state", x.bn_state, out)
                for name in ("shards", "mom"):
                    for b, buf in enumerate(getattr(x, name) or ()):
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


#: the meshes of the schedule checks: (shape, axis names) by name
COMM_MESHES = {"flat": ((COMM_RANKS,), ("data",)),
               "dm": ((COMM_RANKS, 1), ("data", "model")),
               "pod": ((2, 2), ("pod", "data"))}
#: the reference's reduce-scatter forms, and those it also runs with its
#: Pallas ring-step kernel (interpret mode): the ring family
COMM_STRATEGIES = ("psum", "ring", "hierarchical", "2d_torus", "dbtree")
COMM_KERNEL_STRATEGIES = ("ring", "hierarchical", "2d_torus")


def comm_shards():
    """On ``COMM_RANKS`` host devices, device r's gradients
    ``tree * (1 + 0.1 r)`` reduced by each schedule's reduce-scatter-
    terminal form (``ddp.reduce_scatter_grads``, f32 wire) on each mesh of
    ``COMM_MESHES``: the global ``(n * c,)`` shard layout of every bucket,
    row i from the device at index i of the shard axis (the innermost
    non-trivial one; the shard is the same across the other axes), as
    ``{mesh}/{strategy}/k{use_kernel}/{bucket}``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType
    from jax.sharding import PartitionSpec as P
    from repro.core import bucketing, ddp

    tree = comm_tree()
    plan = bucketing.make_plan(tree, bucket_mb=COMM_BUCKET_MB)
    spec = jax.tree.map(lambda _: P(), tree)
    out = {}
    for mname, (shape, names) in COMM_MESHES.items():
        mesh = jax.make_mesh(shape, names,
                             axis_types=(AxisType.Auto,) * len(names))
        shard_axis = [a for a, n in zip(names, shape) if n > 1][-1]
        for strategy in COMM_STRATEGIES:
            for kernel in ((0, 1) if strategy in COMM_KERNEL_STRATEGIES
                           else (0,)):
                def fn(t):
                    r = jnp.float32(0)
                    for a in names:        # the global rank, row-major
                        r = r * jax.lax.axis_size(a) + jax.lax.axis_index(a)
                    g = jax.tree.map(lambda x: x * (1.0 + 0.1 * r), t)
                    return tuple(ddp.reduce_scatter_grads(
                        g, strategy=strategy, axes=names, plan=plan,
                        comm_dtype=jnp.float32, use_kernel=bool(kernel),
                        interpret=True))
                shards = jax.jit(jax.shard_map(
                    fn, mesh=mesh, in_specs=(spec,),
                    out_specs=tuple(P(shard_axis)
                                    for _ in range(plan.n_buckets)),
                    check_vma=False))(tree)
                for b, x in enumerate(shards):
                    out[f"{mname}/{strategy}/k{kernel}/{b}"] = np.asarray(x)
    return out


#: the shapes and masks of ``test_kernels.py::test_flash_attention_vs_oracle``
#: (causal, window 24, non-causal; GQA; Dv != Dk), at f32 and bf16
ATTN_SHAPES = ((2, 64, 4, 2, 32, 32), (1, 128, 2, 2, 16, 16),
               (2, 96, 4, 4, 32, 16))
ATTN_MASKS = ((True, 0), (True, 24), (False, 0))
ATTN_CHUNK = 32
#: decode_attention: (B, Smax, H, K, Dh), the new token's position, windows
DECODE_SHAPES = ((2, 40, 4, 2, 32), (2, 48, 4, 4, 64))
DECODE_POS = 29
DECODE_WINDOWS = (0, 8)


def attention_inputs(shape, dtype_name, seed):
    """q (B,S,H,Dk), k (B,S,K,Dk), v (B,S,K,Dv) as f32 numpy, already
    rounded to ``dtype_name`` (bf16 values are exact in f32)."""
    B, S, H, K, Dk, Dv = shape
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal(s).astype(np.float32)
          for s in ((B, S, H, Dk), (B, S, K, Dk), (B, S, K, Dv))]
    if dtype_name == "bfloat16":
        import torch
        xs = [torch.from_numpy(x).bfloat16().float().numpy() for x in xs]
    return xs


def decode_inputs(shape, dtype_name, seed):
    """q (B,1,H,Dh), k/v caches (B,Smax,K,Dh) as f32 numpy, rounded to
    ``dtype_name``."""
    B, Smax, H, K, Dh = shape
    q, kc, vc = attention_inputs((B, Smax, H, K, Dh, Dh), dtype_name, seed)
    return q[:, :1], kc, vc


def attention_cases():
    """``chunked_attention`` and ``flash_attention_bshd`` (the Pallas kernel
    in interpret mode) at ``ATTN_SHAPES`` x ``ATTN_MASKS`` x {f32, bf16},
    and ``decode_attention`` at ``DECODE_SHAPES`` x ``DECODE_WINDOWS`` x
    {f32, bf16}, on the inputs of ``attention_inputs`` /
    ``decode_inputs``."""
    import jax.numpy as jnp
    from repro.kernels.ops import flash_attention_bshd
    from repro.models.attention import chunked_attention, decode_attention

    out = {}
    for dt in ("float32", "bfloat16"):
        for i, shape in enumerate(ATTN_SHAPES):
            q, k, v = (jnp.asarray(x, dt)
                       for x in attention_inputs(shape, dt, i))
            for causal, window in ATTN_MASKS:
                key = f"{dt}/s{i}/c{int(causal)}w{window}"
                out[f"{key}/chunked"] = chunked_attention(
                    q, k, v, q_offset=0, causal=causal, window=window,
                    chunk=ATTN_CHUNK)
                out[f"{key}/flash"] = flash_attention_bshd(
                    q, k, v, causal=causal, window=window)
        for i, shape in enumerate(DECODE_SHAPES):
            q, kc, vc = (jnp.asarray(x, dt)
                         for x in decode_inputs(shape, dt, 100 + i))
            for window in DECODE_WINDOWS:
                out[f"{dt}/d{i}/w{window}"] = decode_attention(
                    q, kc, vc, jnp.int32(DECODE_POS), window=window)
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


#: the LM parity setting: reduced qwen1.5-0.5b, a 32-token prompt and the
#: 33rd token for one decode step, 8 greedy tokens from a 40-row cache
LM_ARCH = "qwen1.5-0.5b"
LM_BATCH, LM_PROMPT, LM_CACHE, LM_NEW = 2, 32, 40, 8


def lm_params(cfg, seed=0):
    """Reduced-LM params drawn with numpy from the reference's descriptors:
    clipped normals at each leaf's scale; the biases (zeros at init) and
    norm scales (ones) are drawn too, so their paths carry values."""
    import jax
    from repro.models import transformer
    rng = np.random.default_rng(seed)

    def leaf(pd):
        x = np.clip(rng.standard_normal(pd.shape), -2.0, 2.0)
        if pd.init == "normal":
            return (pd.scale * x).astype(np.float32)
        base = {"zeros": 0.0, "ones": 1.0}[pd.init]
        return (base + 0.1 * x).astype(np.float32)

    return jax.tree.map(leaf, transformer.lm_pd(cfg),
                        is_leaf=lambda x: hasattr(x, "init"))


def lm_tokens(cfg, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size,
                        (LM_BATCH, LM_PROMPT + 1)).astype(np.int32)


def lm_cases():
    """Reduced qwen1.5-0.5b with ``flash_attention`` False and True (the
    Pallas kernel in interpret mode), ``mesh=None``: the full forward over
    prompt + 1 tokens, the prefill of the prompt (last logits and cache),
    one decode step of token 33 from that cache, and ``generate``'s greedy
    tokens. ``f{flash}/...``; params as ``params/...``."""
    import dataclasses

    import jax
    from repro.configs import get_config
    from repro.models.registry import build_model

    base = get_config(LM_ARCH).reduced()
    params = lm_params(base)
    toks = lm_tokens(base)
    out = {}
    _flat("params", params, out)
    for flash in (0, 1):
        model = build_model(dataclasses.replace(base,
                                                flash_attention=bool(flash)))
        _flat(f"f{flash}", jax.device_get(_lm_run(model, params, toks)),
              out)
    return out


def _lm_run(model, params, toks):
    import jax
    import jax.numpy as jnp
    from repro.serve.decode import generate

    (logits, _), _ = jax.jit(lambda p, t: model.forward_train(
        p, {"tokens": t}))(params, toks)
    last, cache = jax.jit(lambda p, t: model.forward_prefill(
        p, {"tokens": t}, LM_CACHE))(params, toks[:, :LM_PROMPT])
    dl, cache2 = jax.jit(model.forward_decode)(
        params, cache, toks[:, LM_PROMPT:], jnp.int32(LM_PROMPT))
    gen = generate(model, params, {"tokens": toks[:, :LM_PROMPT]},
                   max_new=LM_NEW, cache_len=LM_CACHE, mesh=None)
    return {"train_logits": logits, "prefill_logits": last, "cache": cache,
            "decode_logits": dl, "decode_cache": cache2, "generate": gen}


#: the LM training parity setting: reduced qwen1.5-0.5b, lcg token batches
#: of the reference's own ``token_batch``, LARS poly2 (``LR``); per case
#: (remat, grad_accum), ``LM_TRAIN_STEPS`` steps along the reference's own
#: trajectory
LM_TRAIN_CASES = {"r0a1": (False, 1), "r1a1": (True, 1), "r0a2": (False, 2)}
LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_STEPS = 4, 32, 2


def lm_train_steps():
    """Reduced qwen1.5-0.5b, ``make_train_step(comm='xla', mesh=None)``
    jitted, for each case of ``LM_TRAIN_CASES`` (the config passed with
    its ``remat``): each step's input and output params and momentum,
    batch and metrics, as ``{case}/s{k}/...``; the step counters as
    ``{case}/s{k}/{in,out}/step``."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.core import lars
    from repro.core.schedule import ScheduleConfig, make_schedule
    from repro.data.synthetic import token_batch
    from repro.models.registry import build_model
    from repro.train.state import TrainState
    from repro.train.step import make_train_step

    base = get_config(LM_ARCH).reduced()
    params = lm_params(base)
    sched = make_schedule(ScheduleConfig(**LR))
    batches = [jax.device_get(token_batch(
        base, batch=LM_TRAIN_BATCH, seq=LM_TRAIN_SEQ, step=k, kind="lcg"))
        for k in range(LM_TRAIN_STEPS)]
    out = {}
    for case, (remat, accum) in LM_TRAIN_CASES.items():
        model = build_model(dataclasses.replace(base, remat=remat))
        step = jax.jit(make_train_step(model, lars.OptConfig(kind="lars"),
                                       sched, mesh=None, comm="xla",
                                       grad_accum=accum))
        s = TrainState(jnp.zeros((), jnp.int32), params,
                       jax.tree.map(np.zeros_like, params))
        for k, batch in enumerate(batches):
            s2, m = step(s, batch)
            pre = f"{case}/s{k}"
            for io, x in (("in", s), ("out", s2)):
                x = jax.device_get(x)
                out[f"{pre}/{io}/step"] = np.asarray(x.step)
                _flat(f"{pre}/{io}/params", x.params, out)
                _flat(f"{pre}/{io}/mom", x.mom, out)
            _flat(f"{pre}/batch", batch, out)
            _flat(f"{pre}/metrics", jax.device_get(m), out)
            s = s2
    return out


#: the explicit-DP LM parity setting: reduced qwen1.5-0.5b at buckets of
#: LM_DP_BUCKET_MB (bf16 wire: 51,200 elements a span, so every stacked
#: weight and the embedding split into spans across buckets), LARS poly2,
#: the lcg batches of ``lm_train_steps``; per case (schedule, sharding,
#: gather) two jitted steps on a (1, 1) Auto-axis mesh
LM_DP_BUCKET_MB = 0.1
LM_DP_CASES = {"psum": ("psum", "replicated", None),
               "ring": ("ring", "replicated", None),
               "zero1": ("ring", "zero1", None),
               "zero2": ("ring", "zero2", None),
               "zero3": ("ring", "zero3", "per_group")}


def lm_dp_steps():
    """Reduced qwen1.5-0.5b through the reference's explicit data-parallel
    step (``make_train_step(comm=CommConfig(...), mesh=...)`` under the
    shard_map shim), for each of ``LM_DP_CASES``: each step's input and
    output state (params absent under zero3, shards under zero2; packed
    momentum and shards as ``{name}/{bucket}``), batch and metrics, as
    ``{case}/s{k}/...``."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType, NamedSharding
    from jax.sharding import PartitionSpec as P
    from repro.configs import get_config
    from repro.configs.base import CommConfig
    from repro.core import lars
    from repro.core.schedule import ScheduleConfig, make_schedule
    from repro.data.synthetic import token_batch
    from repro.models.registry import build_model
    from repro.train import state as st
    from repro.train.step import make_train_step

    _shard_map_shim()
    base = get_config(LM_ARCH).reduced()
    model = build_model(dataclasses.replace(base))
    params = lm_params(base)
    sched = make_schedule(ScheduleConfig(**LR))
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    batches = [jax.device_get(token_batch(
        base, batch=LM_TRAIN_BATCH, seq=LM_TRAIN_SEQ, step=k, kind="lcg"))
        for k in range(LM_TRAIN_STEPS)]
    out = {}
    for case, (strategy, sharding, gather) in LM_DP_CASES.items():
        step = make_train_step(
            model, lars.OptConfig(kind="lars"), sched, mesh=mesh,
            comm=CommConfig(strategy=strategy, sharding=sharding,
                            gather=gather, bucket_mb=LM_DP_BUCKET_MB))
        plan = step.bucket_plan
        if sharding == "replicated":
            s = st.TrainState(jnp.zeros((), jnp.int32), params,
                              jax.tree.map(np.zeros_like, params))
        else:
            s = st.TrainState(
                jnp.zeros((), jnp.int32),
                None if sharding == "zero3" else params,
                st.init_packed_momentum(plan, 1), None,
                None if sharding == "zero2"
                else st.init_packed_shards(params, plan, 1))
        s = jax.device_put(s, NamedSharding(mesh, P()))
        jstep = jax.jit(step)
        for k, batch in enumerate(batches):
            s2, m = jstep(s, batch)
            pre = f"{case}/s{k}"
            for io, x in (("in", s), ("out", s2)):
                x = jax.device_get(x)
                out[f"{pre}/{io}/step"] = np.asarray(x.step)
                if x.params is not None:
                    _flat(f"{pre}/{io}/params", x.params, out)
                if isinstance(x.mom, dict):
                    _flat(f"{pre}/{io}/mom", x.mom, out)
                    continue
                for name in ("shards", "mom"):
                    for b, buf in enumerate(getattr(x, name) or ()):
                        out[f"{pre}/{io}/{name}/{b}"] = np.asarray(buf)
            _flat(f"{pre}/batch", batch, out)
            _flat(f"{pre}/metrics", jax.device_get(m), out)
            s = s2
    return out


if __name__ == "__main__":
    what, dest = sys.argv[1], sys.argv[2]
    np.savez(dest, **{"resnet_grads": resnet_grads,
                      "train_steps": train_steps,
                      "zero1_steps": zero1_steps,
                      "zero23_steps": zero23_steps,
                      "comm_shards": comm_shards,
                      "attention_cases": attention_cases,
                      "lm_cases": lm_cases,
                      "lm_train_steps": lm_train_steps,
                      "lm_dp_steps": lm_dp_steps,
                      "guard_zero1_run": guard_zero1_run,
                      "traced_zero1_step": traced_zero1_step}[what]())
