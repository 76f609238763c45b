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
  python tests/torch_reference.py lm_family_dp_steps:ARCH[,ARCH] OUT.npz
  python tests/torch_reference.py moe_cases OUT.npz
  python tests/torch_reference.py mla_cases OUT.npz
  python tests/torch_reference.py lm_variant_cases OUT.npz
  python tests/torch_reference.py mamba_cases OUT.npz
  python tests/torch_reference.py xlstm_cases OUT.npz
  python tests/torch_reference.py whisper_cases OUT.npz
  python tests/torch_reference.py vlm_cases OUT.npz
  python tests/torch_reference.py guard_zero1_run OUT.npz
  python tests/torch_reference.py traced_zero1_step OUT.npz
  python tests/torch_reference.py tp_cases OUT.npz      (4 host devices)
  python tests/torch_reference.py tp_recurrent_cases OUT.npz   (4 devices)
  python tests/torch_reference.py tp_frames_cases OUT.npz      (4 devices)
  python tests/torch_reference.py tp_moe_cases:layers|lm OUT.npz  (4 devices)
  python tests/torch_reference.py tp_mla_cases:PART OUT.npz  (4 devices;
      PART: block, run, train0, train1)
  python tests/torch_reference.py xla_conv_cases OUT.npz       (2 devices)

The reference's explicit data-parallel steps fail under jax 0.9.0 before
they compute anything: ``repro/core/compat.py`` passes ``check_rep=`` to
``jax.shard_map``, which now takes ``check_vma=``, and ``jax.make_mesh``
now makes Explicit axes, which the step's sharding constraints reject.
``zero1_steps``, ``zero23_steps``, ``lm_dp_steps``,
``lm_family_dp_steps``, ``guard_zero1_run`` and ``traced_zero1_step``
route around both without touching
``src/repro``: each replaces ``compat.shard_map`` in its own process with
a shim that calls ``jax.shard_map(..., check_vma=False)``, builds an
Auto-axis mesh, and feeds numpy batches (no mesh-bound batch function).
The reference's MoE layer runs only inside ``shard_map`` on a mesh with a
``model`` axis, and ``repro/models/moe.py`` binds ``shard_map`` at import:
``moe_cases`` and ``mla_cases`` set the shim there too and run on a
(1, 1) Auto-axis ``("data", "model")`` mesh. ``repro/models/attention.py``
binds it at import too (its flash path under a model axis runs K5 in
``shard_map``), and so does ``repro/models/resnet.py`` (its ``sync_bn``
statistics are a ``pmean`` in ``shard_map``); the shim sets it in all
three, whatever was imported first: ``tp_cases`` and
``tp_recurrent_cases`` run the reference's GSPMD program on a (2, 2)
Auto-axis mesh, ``xla_conv_cases`` its ResNet step on a (2, 1) one.
"""
import contextlib
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

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
    return load(out)


def load(out: str) -> dict:
    """A saved ``.npz`` of ``kind/path`` keys as nested dicts."""
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
    docstring), and the names ``repro.models.moe``,
    ``repro.models.attention`` and ``repro.models.resnet`` (its
    ``sync_bn`` statistics) bound from it at import; replaced in this
    process only."""
    import jax
    from repro.core import compat
    from repro.models import attention, moe, resnet

    def shard_map(f, *, mesh, in_specs, out_specs, check_rep=False):
        return jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                             out_specs=out_specs, check_vma=False)
    compat.shard_map = shard_map
    moe.shard_map = shard_map
    attention.shard_map = shard_map
    resnet.shard_map = shard_map


def _mesh11():
    """The (1, 1) ``("data", "model")`` mesh with Auto axes (jax 0.9's
    ``make_mesh`` makes Explicit ones, which the steps' sharding
    constraints reject)."""
    import jax
    from jax.sharding import AxisType
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


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
    from repro.models import transformer
    return draw_params(transformer.lm_pd(cfg), seed)


def draw_params(pd_tree, seed):
    """``lm_params``' draw over any descriptor tree of the reference."""
    import jax
    rng = np.random.default_rng(seed)

    def leaf(pd):
        x = np.clip(rng.standard_normal(pd.shape), -2.0, 2.0)
        if pd.init == "normal":
            return (pd.scale * x).astype(np.float32)
        base = {"zeros": 0.0, "ones": 1.0, "const": pd.scale}[pd.init]
        return (base + 0.1 * x).astype(np.float32)

    return jax.tree.map(leaf, pd_tree, is_leaf=lambda x: hasattr(x, "init"))


def lm_tokens(cfg, seed=1, prompt=LM_PROMPT):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size,
                        (LM_BATCH, prompt + 1)).astype(np.int32)


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


def _lm_run(model, params, toks, *, prompt=LM_PROMPT, cache_len=LM_CACHE,
            mesh=None, via_generate=True, decode=None, frames=None,
            train_len=None):
    """The full forward over ``toks`` (prompt + 1 tokens, or its first
    ``train_len``: the MoE layer over a model axis cannot shard a length
    the axis does not divide; with its aux),
    the prefill of the prompt, one decode step of the last token from that
    cache, and ``generate``'s LM_NEW greedy tokens; with ``via_generate``
    False the same tokens from the prefill and decode programs already
    compiled here (``generate``'s loop: the argmax of the last logits fed
    back), which saves ``generate`` compiling both again, and ``decode``,
    given, is a jitted ``forward_decode(p, c, t, i)`` of another run to
    reuse (the decode takes no flash kernel). ``frames``: whisper's and
    the VLM's stub frames, in every batch (the VLM's image prefix moves
    the decode positions by its length)."""
    import jax
    import jax.numpy as jnp
    from repro.serve.decode import generate

    extra = {} if frames is None else {"frames": frames}
    start = prompt + (model.cfg.encoder.n_frames
                      if model.cfg.family == "vlm" else 0)
    (logits, aux), _ = jax.jit(lambda p, t: model.forward_train(
        p, {"tokens": t, **extra}, mesh))(params, toks[:, :train_len])
    last, cache = jax.jit(lambda p, t: model.forward_prefill(
        p, {"tokens": t, **extra}, cache_len, mesh))(params,
                                                    toks[:, :prompt])
    decode = decode or jax.jit(lambda p, c, t, i: model.forward_decode(
        p, c, t, i, mesh))
    dl, cache2 = decode(params, cache, toks[:, prompt:], jnp.int32(start))
    if via_generate:
        gen = generate(model, params, {"tokens": toks[:, :prompt], **extra},
                       max_new=LM_NEW, cache_len=cache_len, mesh=mesh)
    else:
        pick = lambda lg: jnp.argmax(lg[:, -1], axis=-1).astype(
            jnp.int32)[:, None]
        out, c = [pick(last)], cache
        for i in range(LM_NEW - 1):
            lg, c = decode(params, c, out[-1], jnp.int32(start + i))
            out.append(pick(lg))
        gen = jnp.concatenate(out, axis=1)
    return {"train_logits": logits, "train_aux": aux,
            "prefill_logits": last, "cache": cache, "decode_logits": dl,
            "decode_cache": cache2, "generate": gen}


def check_greedy_tokens(model, params, toks, want, got, cache_len, *,
                        rel_margin=None, frames=None, mesh=None):
    """The port's greedy tokens ``got`` against the reference's ``want``
    (both (B, LM_NEW)) from the prompt ``toks``. The logits are bf16
    values (the head's bf16 matmul), so two can tie, and where the two
    packages' last-bit differences flip such a tie the sequences part. So:
    along the reference's tokens (teacher-forced through the port's prefill
    and decode), each of the reference's picks is within one bf16 ulp of
    the port's largest logit, and each request's tokens are equal up to
    its first step whose two largest logits lie within one bf16 ulp of
    each other (all of them where there is none). A model whose logits
    are held to the reference's only within ``rel_margin`` of their max
    takes that margin (of the step's largest |logit|) in place of the
    ulp. ``frames``: whisper's and the VLM's stub frames. ``mesh``: the
    port over that mesh's model axis (``params`` a rank's shards, the rows
    its own). Returns the number of such tied steps a request."""
    import torch
    from repro_torch.serve.decode import prefix_len
    prompt = toks.shape[1] + prefix_len(model.cfg)
    batch = {"tokens": toks}
    if frames is not None:
        batch["frames"] = frames
    logits, cache = model.forward_prefill(params, batch, cache_len, mesh)
    tied = np.zeros(want.shape, bool)
    for i in range(want.shape[1]):
        lg = logits[:, -1].float()
        top = torch.topk(lg, 2).values
        ulp = (2.0 ** (torch.floor(torch.log2(top[:, 0].abs())) - 7)
               if rel_margin is None
               else rel_margin * lg.abs().amax(dim=-1))
        picked = lg[torch.arange(lg.shape[0]), torch.from_numpy(want[:, i])
                    .long()]
        assert bool((top[:, 0] - picked <= ulp).all()), (i, top, picked)
        tied[:, i] = (top[:, 0] - top[:, 1] <= ulp).numpy()
        if i + 1 < want.shape[1]:
            logits, cache = model.forward_decode(
                params, cache, torch.from_numpy(want[:, i:i + 1]),
                prompt + i, mesh)
    for b in range(want.shape[0]):
        first = int(np.argmax(tied[b])) if tied[b].any() else want.shape[1]
        np.testing.assert_array_equal(got[b, :first], want[b, :first])
    return tied.sum(1)


def check_train_step(r, base, *, loss_rtol, update_tol, f32=False):
    """The port's ``comm='xla'`` LARS step (``LR``) from a reference
    step's input state ``r['in']`` on its batch, against its output: the
    loss within ``loss_rtol`` relative, and each tensor's new params
    within ``update_tol`` of the reference's largest update element of
    that tensor. With ``f32`` the step differentiates the f32 masters
    (``comm_dtype='f32'``) and the LM runs wholly in f32
    (``precision.f32_compute``), as ``_train_steps`` ran the
    reference. Returns (loss relative difference, the worst tensor's
    difference over its largest update, that tensor's path, the new
    state)."""
    import contextlib
    import types

    import torch
    from repro_torch import weights
    from repro_torch.core import lars, precision
    from repro_torch.core.schedule import ScheduleConfig, make_schedule
    from repro_torch.models.registry import build_model
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import tree_flatten

    step = make_train_step(build_model(base), lars.OptConfig(kind="lars"),
                           make_schedule(ScheduleConfig(**LR)), comm="xla",
                           comm_dtype="f32" if f32 else "bf16")
    state_in = weights.lm_state_from_jax(types.SimpleNamespace(**r["in"]),
                                         base, "cpu")
    batch = {n: torch.from_numpy(v) for n, v in r["batch"].items()}
    with precision.f32_compute() if f32 else contextlib.nullcontext():
        state, metrics = step(state_in, batch)
    assert state.step == int(r["out"]["step"])
    d_loss = abs(float(metrics["loss"]) - float(r["metrics"]["loss"])) \
        / abs(float(r["metrics"]["loss"]))
    p_in = dict(tree_flatten(r["in"]["params"]))
    got = dict(tree_flatten(weights.to_numpy(state.params)))
    want = dict(tree_flatten(r["out"]["params"]))
    assert set(got) == set(want)
    worst = max((np.abs(got[n] - want[n]).max()
                 / max(np.abs(want[n] - p_in[n]).max(), 1e-30), n)
                for n in want)
    assert d_loss <= loss_rtol, d_loss
    assert worst[0] <= update_tol, worst
    return d_loss, worst[0], worst[1], state


#: a leaf whose reference f32 gradient stays within this share of the
#: tree's largest gradient is zero up to f32 rounding: its exact value
#: vanishes (as the sLSTM input gate's bias's does: a shift of that gate
#: at every step scales c and n alike and cancels in h = o · c / n), and
#: both sides hold rounding noise there
F32_ZERO = 2.0 ** -23


def zero_grad_leaves(cfg):
    """The paths of ``cfg``'s LM whose gradient vanishes up to f32
    rounding (``F32_ZERO``): each sLSTM block's input-gate bias."""
    if cfg.xlstm is None:
        return ()
    pat = cfg.xlstm.pattern
    return tuple(f"layer_{i:02d}/blk/b_i" for i in range(cfg.n_layers)
                 if pat[i % len(pat)] == "s")


def leaf_grad_errors(pairs):
    """``pairs``: {path: (the port's f32 gradient, the reference's)}. Each
    leaf's largest difference over its own largest reference gradient,
    save the leaves whose reference gradient is zero up to rounding
    (``F32_ZERO`` of the tree's largest), whose port gradient must be so
    too. Returns ({path: error} over the other leaves, the zero leaves)."""
    scale = max(float(np.abs(w).max()) for _, w in pairs.values())
    errors, zero = {}, []
    for path, (g, w) in pairs.items():
        top = float(np.abs(w).max())
        if top <= F32_ZERO * scale:
            assert float(np.abs(g).max()) <= F32_ZERO * scale, path
            zero.append(path)
        else:
            errors[path] = float(np.abs(g - w).max()) / top
    return errors, zero


def module_grads_error(fn, r, name, S, cfg):
    """The port's f32 gradients of ``sum(fn(p, x, cfg)[0] · ct)`` with
    respect to the params and x, on the reference's ``{name}`` module
    inputs at length S, against the reference's
    (``_recurrent_module_cases``), leaf by leaf (``leaf_grad_errors``):
    returns (the worst leaf's error, its path, the zero leaves)."""
    import torch
    params = {n: torch.tensor(v, requires_grad=True)
              for n, v in r[name]["params"].items()}
    x = torch.tensor(r[name][f"x{S}"], requires_grad=True)
    out, _ = fn(params, x, cfg)
    (out * torch.from_numpy(r[name][f"ct{S}"])).sum().backward()
    want = r[name]["float32"][f"s{S}"]["grads"]
    pairs = {n: (params[n].grad.numpy(), want["params"][n]) for n in params}
    pairs["x"] = (x.grad.numpy(), want["x"])
    errors, zero = leaf_grad_errors(pairs)
    return (*max((e, n) for n, e in errors.items()), zero)


def lm_f32_errors(base, r):
    """``_lm_f32_case`` on the port: its LM wholly in f32
    (``precision.f32_compute``, the params from ``params/``)
    against the reference's; returns (the logits' largest difference over
    their max, the worst leaf's gradient error, its path, the zero leaves:
    ``leaf_grad_errors``)."""
    import torch
    from repro_torch import weights
    from repro_torch.core import precision
    from repro_torch.models import transformer
    from repro_torch.tree import tree_flatten, tree_unflatten

    params = weights.lm_params_from_jax(r["params"], base, "cpu")
    flat = dict(tree_flatten(params))
    for t in flat.values():
        t.requires_grad_()
    batch = {"tokens": torch.from_numpy(lm_tokens(base))}
    if "frames" in r:
        batch["frames"] = torch.from_numpy(r["frames"])
    with precision.f32_compute():
        logits, _ = transformer.forward_train(
            tree_unflatten(list(flat), list(flat.values())), base, batch)
    (logits * torch.from_numpy(r["f32"]["ct"])).sum().backward()
    want = dict(tree_flatten(r["f32"]["grads"]))
    assert set(want) == set(flat)
    want_logits = r["f32"]["logits"]
    d_logits = float(np.abs(logits.detach().numpy() - want_logits).max()
                     / np.abs(want_logits).max())
    errors, zero = leaf_grad_errors({n: (flat[n].grad.numpy(), w)
                                     for n, w in want.items()})
    return (d_logits, *max((e, n) for n, e in errors.items()), zero)


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


#: the MoE module cases: name -> (n_routed, top_k). "cap" is the reduced
#: qwen2-moe-a2.7b's own routing (4 experts, top-2, capacity factor 1.25);
#: "pad" has 20 routed experts, top-4, so the stack pads to 32 and the
#: dead slots are exercised. Inputs: MOE_B x MOE_S tokens of N(0, 1) plus
#: a shared direction of scale MOE_SKEW, which skews the router towards
#: some experts so that their buffers overflow and tokens are dropped
MOE_CASES = {"cap": (4, 2), "pad": (20, 4)}
MOE_B, MOE_S, MOE_SKEW = 2, 32, 0.5
MOE_ARCH = "qwen2-moe-a2.7b"


def moe_case_cfg(get_config, case):
    """The case's config, from either package's ``get_config``."""
    import dataclasses
    base = get_config(MOE_ARCH).reduced()
    n_routed, top_k = MOE_CASES[case]
    return dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, n_routed=n_routed, top_k=top_k))


def _moe_inputs(cfg, seed):
    """The MoE layer's params (numpy, from the reference's descriptors) and
    its input x (MOE_B, MOE_S, d) f32."""
    import jax
    from repro.models import moe
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda pd: (pd.scale * np.clip(rng.standard_normal(pd.shape), -2,
                                       2)).astype(np.float32),
        moe.moe_pd(cfg), is_leaf=lambda x: hasattr(x, "init"))
    x = rng.standard_normal((MOE_B, MOE_S, cfg.d_model)) \
        + MOE_SKEW * rng.standard_normal(cfg.d_model)
    return params, x.astype(np.float32)


#: the MoE LM training setting: the reduced qwen2-moe-a2.7b, the lcg
#: batches and schedule of ``lm_train_steps``, MOE_TRAIN_STEPS steps
MOE_TRAIN_STEPS = 2


def moe_cases():
    """The reference's MoE on a (1, 1) Auto-axis mesh, under the shard_map
    shim. (1) ``_moe_layer_case`` for each of ``MOE_CASES``
    (``{case}/...``). (2) The reduced qwen2-moe-a2.7b's ``_lm_run`` with
    ``flash_attention`` False and True (``f{flash}/...``, params
    ``params/...``). (3) Its ``_xla_train_run`` (``train/s{k}/...``)."""
    from repro.configs import get_config

    _shard_map_shim()
    mesh = _mesh11()
    out = {}
    for i, case in enumerate(MOE_CASES):
        _moe_layer_case(moe_case_cfg(get_config, case), 10 + i, case, mesh,
                        out, grads=True)
    base = get_config(MOE_ARCH).reduced()
    _lm_family_cases(base, mesh, out)
    return out


def _device_index(mesh):
    """Inside ``shard_map`` over ``mesh``: the device's index along each
    of its axes (a debug callback fires once a device, with its own)."""
    import jax
    import jax.numpy as jnp
    return jnp.stack([jax.lax.axis_index(a) for a in mesh.axis_names])


def _by_device(captured, key, out):
    """Each device's capture ``captured[(i, j)]`` as ``{key}/d{i}m{j}``;
    on a one-device mesh as ``{key}`` alone."""
    if list(captured) == [(0, 0)]:
        out[key] = captured[(0, 0)]
        return
    for (i, j), v in captured.items():
        out[f"{key}/d{i}m{j}"] = v


#: where ``_route_capture``'s callbacks record: a program traced under one
#: capture and run again under the next records into the current one
_ROUTED = [None]


def _keep_route(idx, ids):
    _ROUTED[0].setdefault(tuple(int(i) for i in idx), []).append(
        np.asarray(ids))


@contextlib.contextmanager
def _route_capture(mesh):
    """Within: each call of ``repro.models.moe._route`` inside the MoE
    layer's ``shard_map`` over ``mesh`` records its expert ids under the
    (data, model) index of the device that ran it; yields {index: [ids,
    ...]}, each device's in the order its layers ran (call
    ``jax.effects_barrier()`` before reading it)."""
    import jax
    from repro.models import moe
    route = moe._route

    def capturing_route(x_flat, router_w, e):
        gates, ids, aux = route(x_flat, router_w, e)
        jax.debug.callback(_keep_route, _device_index(mesh), ids)
        return gates, ids, aux

    moe._route = capturing_route
    _ROUTED[0] = {}
    try:
        yield _ROUTED[0]
    finally:
        moe._route = route


def _moe_layer_case(cfg, seed, prefix, mesh, out, *, grads,
                    modes=("train", "decode"), seq=None, route=True):
    """``moe_apply`` on ``_moe_inputs(cfg, seed)`` (its first ``seq``
    tokens a row, given) in f32 and bf16, in
    each of ``modes`` (train, decode): out and aux
    (``{prefix}/{dt}/{mode}/...``); with ``route``, the routing of
    ``_route`` on the same x (gates, ids, aux); in train, the
    buffers the expert FFN receives (``xs``: (E, C, d) on one device,
    each device's (E/M, M·C, d) as ``xs/d{i}m{j}`` on several, captured by
    a debug callback), and with ``grads``, in f32, the gradients of
    ``sum(out · ct) + 0.01 · aux`` with respect to the params and x. The
    params and x as ``{prefix}/params/...`` and ``{prefix}/x``."""
    import jax
    import jax.numpy as jnp
    from repro.models import moe

    captured = {}
    ffn = moe._expert_ffn

    def keep(idx, xs):
        captured[tuple(int(i) for i in idx)] = np.asarray(xs, np.float32)

    def capturing_ffn(w_gate, w_up, w_down, xs):
        jax.debug.callback(keep, _device_index(mesh), xs)
        return ffn(w_gate, w_up, w_down, xs)

    p32, x32 = _moe_inputs(cfg, seed)
    if seq is not None:
        x32 = np.ascontiguousarray(x32[:, :seq])
    _flat(f"{prefix}/params", p32, out)
    out[f"{prefix}/x"] = x32
    for dt in ("float32", "bfloat16"):
        p = jax.tree.map(lambda a: jnp.asarray(a, dt), p32)
        x = jnp.asarray(x32, dt)
        if route:
            gates, ids, aux = jax.jit(lambda xf, w: moe._route(
                xf, w, cfg.moe))(x.reshape(-1, cfg.d_model), p["router"])
            for name, v in (("gates", gates), ("ids", ids), ("aux", aux)):
                out[f"{prefix}/{dt}/route/{name}"] = np.asarray(v)
        for mode in modes:
            key = f"{prefix}/{dt}/{mode}"
            moe._expert_ffn = capturing_ffn
            captured.clear()
            try:
                o, a = jax.jit(lambda p, x, d=mode == "decode":
                               moe.moe_apply(p, x, cfg, mesh, decode=d)
                               )(p, x)
                jax.effects_barrier()
            finally:
                moe._expert_ffn = ffn
            out[f"{key}/out"] = np.asarray(o, np.float32)
            out[f"{key}/aux"] = np.asarray(a)
            if mode == "train":
                _by_device(captured, f"{key}/xs", out)
            if grads and mode == "train" and dt == "float32":
                ct = np.random.default_rng(seed + 10).standard_normal(
                    x32.shape).astype(np.float32)

                def loss(p, x):
                    o, a = moe.moe_apply(p, x, cfg, mesh, decode=False)
                    return jnp.sum(o * ct) + 0.01 * a
                gp, gx = jax.jit(jax.grad(loss, (0, 1)))(p, x)
                out[f"{key}/ct"] = ct
                _flat(f"{key}/grads", jax.device_get(gp), out)
                out[f"{key}/grads/x"] = np.asarray(gx)


def _lm_family_cases(base, mesh, out):
    """A reduced MoE LM on ``mesh``: params (``params/...``), ``_lm_run``
    with ``flash_attention`` False and True (``f{flash}/...``), and
    ``make_train_step(comm='xla', mesh=mesh)``, jitted, MOE_TRAIN_STEPS
    steps along its own trajectory from those params, LARS poly2
    (``LR``), the lcg batches of ``lm_train_steps`` (``train/s{k}/...``),
    with each layer's expert ids of the step's forward, in layer order
    (``train/s{k}/route/l{i}``, captured by a debug callback: ``_routes``)."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    from repro.core import lars
    from repro.core.schedule import ScheduleConfig, make_schedule
    from repro.data.synthetic import token_batch
    from repro.models.registry import build_model
    from repro.train.state import TrainState
    from repro.train.step import make_train_step

    params = lm_params(base)
    toks = lm_tokens(base)
    _flat("params", params, out)
    for flash in (0, 1):
        model = build_model(dataclasses.replace(base,
                                                flash_attention=bool(flash)))
        _flat(f"f{flash}", jax.device_get(_lm_run(model, params, toks,
                                                  mesh=mesh)), out)

    model = build_model(base)
    step = jax.jit(make_train_step(model, lars.OptConfig(kind="lars"),
                                   make_schedule(ScheduleConfig(**LR)),
                                   mesh=mesh, comm="xla"))
    s = TrainState(jnp.zeros((), jnp.int32), params,
                   jax.tree.map(np.zeros_like, params))
    for k in range(MOE_TRAIN_STEPS):
        batch = jax.device_get(token_batch(
            base, batch=LM_TRAIN_BATCH, seq=LM_TRAIN_SEQ, step=k,
            kind="lcg"))
        # each layer's expert choices of the step's forward, in the order
        # the scan runs the layers
        with _route_capture(mesh) as routed:
            s2, m = step(s, batch)
            jax.effects_barrier()
        pre = f"train/s{k}"
        _routes(routed, pre, out)
        for io, x in (("in", s), ("out", s2)):
            x = jax.device_get(x)
            out[f"{pre}/{io}/step"] = np.asarray(x.step)
            _flat(f"{pre}/{io}/params", x.params, out)
            _flat(f"{pre}/{io}/mom", x.mom, out)
        _flat(f"{pre}/batch", batch, out)
        _flat(f"{pre}/metrics", jax.device_get(m), out)
        # on the host, as the first state: the step then runs the program
        # it compiled (the outputs' mesh shardings would compile another)
        s = jax.device_get(s2)


def _routes(routed, pre, out):
    """``_route_capture``'s ids as ``{pre}/route/l{i}`` (layer i), each
    device's as ``.../d{d}m{m}`` on a mesh of several."""
    n = {len(v) for v in routed.values()}
    assert len(n) == 1, n            # as many layers on every device
    for i in range(n.pop()):
        _by_device({idx: v[i] for idx, v in routed.items()},
                   f"{pre}/route/l{i}", out)


#: the MLA setting: the reduced deepseek-v2-236b (2 layers, d 256, 4
#: heads, kv_lora 64, rope 16, nope 32, v 32; 4 routed experts top-2, 1
#: shared; vocab 512) at the LM parity sizes (LM_BATCH x LM_PROMPT tokens,
#: LM_CACHE rows). The in-place decodes write layer MLA_LAYER of stacked
#: caches; GQA_INPLACE_ARCHS are the GQA configs of ``gqa_decode_inplace``
#: (QKV bias, MHA; qk_norm, 4 heads on 1 kv head)
MLA_ARCH = "deepseek-v2-236b"
MLA_LAYER = 1
GQA_INPLACE_ARCHS = ("qwen1.5-0.5b", "qwen3-14b")


def _stack_around(layer_cache, n_layers, rng):
    """(L, ...) stacked caches: ``layer_cache`` at MLA_LAYER, the other
    layers N(0, 1) in its dtype."""
    import jax.numpy as jnp
    shape = (n_layers, *layer_cache.shape)
    stack = jnp.asarray(rng.standard_normal(shape), layer_cache.dtype)
    return stack.at[MLA_LAYER].set(layer_cache)


def mla_cases():
    """The reduced deepseek-v2-236b. (1) ``mla_parallel`` with
    ``mesh=None`` on ``mla/x`` (LM_BATCH x LM_PROMPT x d, N(0, 1)) with
    LM_CACHE rows of cache, in f32 and bf16, flash off and on (the Pallas
    kernel in interpret mode): out and cache (``mla/{dt}/f{flash}/...``);
    from the flash-off cache, ``mla_decode`` of ``mla/x_dec`` at
    position LM_PROMPT (``mla/{dt}/decode/...``), and
    ``mla_decode_inplace`` of it into stacked caches holding that cache at
    MLA_LAYER (``mla/{dt}/inplace/{in,out}/...``). (2) For each of
    GQA_INPLACE_ARCHS, ``gqa_decode_inplace`` at position LM_PROMPT into
    N(0, 1) stacked (L, LM_BATCH, LM_CACHE, K, Dh) caches, layer
    MLA_LAYER, f32 and bf16 (``gqa/{arch}/...``). (3) On a (1, 1)
    Auto-axis mesh under the shard_map shim: the MoE layer of the reduced
    config in train mode (``_moe_layer_case``, ``moe/...``: routing and
    dispatch at deepseek's routing; ``moe_cases`` holds the rest of
    ``moe.py``) and the MLA LM
    (``_lm_family_cases``)."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.models import attention as attn

    out = {}
    cfg = get_config(MLA_ARCH).reduced()
    rng = np.random.default_rng(30)
    p32 = draw_params(attn.mla_pd(cfg), 31)
    x32 = rng.standard_normal((LM_BATCH, LM_PROMPT, cfg.d_model)) \
        .astype(np.float32)
    xd32 = rng.standard_normal((LM_BATCH, 1, cfg.d_model)).astype(np.float32)
    _flat("mla/params", p32, out)
    out["mla/x"], out["mla/x_dec"] = x32, xd32
    positions = jnp.arange(LM_PROMPT)[None]
    pos = jnp.int32(LM_PROMPT)
    for dt in ("float32", "bfloat16"):
        p = jax.tree.map(lambda a: jnp.asarray(a, dt), p32)
        x, xd = jnp.asarray(x32, dt), jnp.asarray(xd32, dt)
        for flash in (0, 1):
            c = dataclasses.replace(cfg, flash_attention=bool(flash))
            o, cache = jax.jit(lambda p, x, c=c: attn.mla_parallel(
                p, x, positions, c, cache_len=LM_CACHE))(p, x)
            _flat(f"mla/{dt}/f{flash}", {"out": o, "cache": cache}, out)
            if not flash:
                cache0 = cache
        o, cache = jax.jit(lambda p, x, c, i: attn.mla_decode(
            p, x, i, cfg, c))(p, xd, cache0, pos)
        _flat(f"mla/{dt}/decode", {"out": o, "cache": cache}, out)
        stack = {n: _stack_around(cache0[n], cfg.n_layers, rng)
                 for n in ("ckv", "krope")}
        o, ckv, kr = jax.jit(lambda p, x, a, b, i: attn.mla_decode_inplace(
            p, x, i, cfg, a, b, MLA_LAYER))(p, xd, stack["ckv"],
                                            stack["krope"], pos)
        _flat(f"mla/{dt}/inplace", {"in": stack, "out": {
            "out": o, "ckv": ckv, "krope": kr}}, out)

    for arch in GQA_INPLACE_ARCHS:
        g = get_config(arch).reduced()
        gp32 = draw_params(attn.gqa_pd(g), 32)
        shape = (g.n_layers, LM_BATCH, LM_CACHE, g.n_kv_heads,
                 g.resolved_head_dim)
        ck32, cv32 = (rng.standard_normal(shape).astype(np.float32)
                      for _ in range(2))
        gx32 = rng.standard_normal((LM_BATCH, 1, g.d_model)) \
            .astype(np.float32)
        pre = f"gqa/{arch}"
        _flat(f"{pre}/params", gp32, out)
        out[f"{pre}/x"], out[f"{pre}/k"], out[f"{pre}/v"] = gx32, ck32, cv32
        for dt in ("float32", "bfloat16"):
            gp = jax.tree.map(lambda a: jnp.asarray(a, dt), gp32)
            o, ck, cv = jax.jit(lambda p, x, a, b, i, g=g:
                                attn.gqa_decode_inplace(p, x, i, g, a, b,
                                                        MLA_LAYER))(
                gp, jnp.asarray(gx32, dt), jnp.asarray(ck32, dt),
                jnp.asarray(cv32, dt), pos)
            _flat(f"{pre}/{dt}", {"out": o, "k": ck, "v": cv}, out)

    _shard_map_shim()
    mesh = _mesh11()
    _moe_layer_case(cfg, 40, "moe", mesh, out, grads=False,
                    modes=("train",))
    _lm_family_cases(cfg, mesh, out)
    return out


#: the dense variants: arch -> (prompt length, flash cases). qwen3-14b
#: (qk_norm, 4 heads on 1 kv head) and qwen1.5-32b (QKV bias, MHA) with
#: the 32-token prompt; mistral-nemo-12b's reduced window is 32, so its
#: prompt is 64 tokens and the window bites in the prefill and the decode
LM_VARIANTS = {"qwen3-14b": (32, (0, 1)),
               "mistral-nemo-12b": (64, (0, 1)),
               "qwen1.5-32b": (32, (0,))}


def lm_variant_cases():
    """Each reduced dense variant of ``LM_VARIANTS``: params
    (``{arch}/params/...``) and ``_lm_run`` with ``mesh=None`` for each of
    its flash cases (``{arch}/f{flash}/...``); the cache is prompt + 8
    rows."""
    import dataclasses

    import jax
    from repro.configs import get_config
    from repro.models.registry import build_model

    out = {}
    for arch, (prompt, flashes) in LM_VARIANTS.items():
        base = get_config(arch).reduced()
        params = lm_params(base)
        toks = lm_tokens(base, prompt=prompt)
        _flat(f"{arch}/params", params, out)
        for flash in flashes:
            model = build_model(dataclasses.replace(
                base, flash_attention=bool(flash)))
            _flat(f"{arch}/f{flash}", jax.device_get(_lm_run(
                model, params, toks, prompt=prompt,
                cache_len=prompt + LM_NEW)), out)
    return out


class _F32Numpy:
    """``jax.numpy`` with ``bfloat16`` read as ``float32``: set as
    ``repro.models.transformer.jnp`` by ``_jax_f32_compute``, it turns
    the casts to bf16 written in that module (whisper's frames and
    position tables, the VLM's projected prefix) into f32 ones."""

    def __init__(self, jnp):
        self._jnp = jnp
        self.bfloat16 = jnp.float32

    def __getattr__(self, name):
        return getattr(self._jnp, name)


@contextlib.contextmanager
def _jax_f32_compute():
    """The reference's LM wholly in f32 on f32 params while tracing (the
    counterpart of the port's ``precision.f32_compute``): the model's
    ``cast_to_compute`` (registry) and ``transformer._embed`` round to
    bf16, and are replaced in this process only by the identity and the
    lookup alone; the module's other casts to bf16 by f32 ones
    (``_F32Numpy``)."""
    from repro.models import registry, transformer
    cast, embed, jnp = (registry.cast_to_compute, transformer._embed,
                        transformer.jnp)
    registry.cast_to_compute = lambda params: params
    transformer._embed = lambda p, cfg, tokens: p["embed"][tokens]
    transformer.jnp = _F32Numpy(jnp)
    try:
        yield
    finally:
        registry.cast_to_compute, transformer._embed = cast, embed
        transformer.jnp = jnp


def _train_steps(base, params, out, *, f32=False, mesh=None,
                 prefix="train", kind="lars", routes=False):
    """``make_train_step(comm='xla', mesh=mesh)``, jitted, LM_TRAIN_STEPS
    steps along its own trajectory from ``params``, ``kind`` (LARS; or
    sgdm, whose update scales with the gradient) poly2 (``LR``),
    the lcg batches of ``lm_train_steps``: each step's input and output
    states, batch and metrics (``{prefix}/s{k}/...``); with ``f32`` the
    step differentiates the f32 masters (``comm_dtype='f32'``) and the LM
    runs wholly in f32 (``_jax_f32_compute``). With a ``mesh`` the params
    and momentum are placed by their specs (``_place``). With ``routes``
    (a MoE config) each layer's expert ids a device as well
    (``_route_capture``, ``{prefix}/s{k}/route/...``)."""
    import jax
    import jax.numpy as jnp
    from repro.core import lars
    from repro.core.schedule import ScheduleConfig, make_schedule
    from repro.data.synthetic import token_batch
    from repro.models.registry import build_model
    from repro.train.state import TrainState
    from repro.train.step import make_train_step

    model = build_model(base)
    step = jax.jit(make_train_step(model, lars.OptConfig(kind=kind),
                                   make_schedule(ScheduleConfig(**LR)),
                                   mesh=mesh, comm="xla",
                                   comm_dtype="f32" if f32 else "bf16"))
    mom = jax.tree.map(np.zeros_like, params)
    if mesh is not None:
        params, mom = (_place(t, model.param_pd, mesh)
                       for t in (params, mom))
    s = TrainState(jnp.zeros((), jnp.int32), params, mom)
    for k in range(LM_TRAIN_STEPS):
        batch = jax.device_get(token_batch(
            base, batch=LM_TRAIN_BATCH, seq=LM_TRAIN_SEQ, step=k,
            kind="lcg"))
        with _jax_f32_compute() if f32 else contextlib.nullcontext(), \
                _route_capture(mesh) if routes \
                else contextlib.nullcontext() as routed:
            s2, m = step(s, batch)
            jax.effects_barrier()
        pre = f"{prefix}/s{k}"
        if routes:
            _routes(routed, pre, out)
        for io, x in (("in", s), ("out", s2)):
            x = jax.device_get(x)
            out[f"{pre}/{io}/step"] = np.asarray(x.step)
            _flat(f"{pre}/{io}/params", x.params, out)
            _flat(f"{pre}/{io}/mom", x.mom, out)
        _flat(f"{pre}/batch", batch, out)
        _flat(f"{pre}/metrics", jax.device_get(m), out)
        s = s2 if mesh is None else _replaced(s2, model, mesh)


def _replaced(s, model, mesh):
    """A step's output state placed as its input was (the step counter
    uncommitted, the params and momentum by their specs), so that the
    next step reuses the compiled program: its outputs carry the
    shardings XLA chose, and other input shardings compile it again."""
    import jax
    import jax.numpy as jnp
    from repro.train.state import TrainState
    s = jax.device_get(s)
    return TrainState(jnp.asarray(s.step), *(
        _place(t, model.param_pd, mesh) for t in (s.params, s.mom)))


#: the recurrent families' module inputs: N(0, 1) (LM_BATCH, S, d) at each
#: of SSM_LENGTHS, a multiple of the reduced chunk (16) and not (the
#: prefill then takes the largest divisor chunk, 11), and one decode token
SSM_LENGTHS = (32, 33)
#: the hybrid setting: the reduced zamba2-7b (4 Mamba layers in 2 groups
#: of 2, d 256, 16 SSM heads of 32, state 16, chunk 16; the shared block's
#: 4 heads of 64; vocab 512) at the LM parity sizes
HYBRID_ARCH = "zamba2-7b"
#: the xLSTM setting: the reduced xlstm-125m (d 256, 4 heads, chunk 16) at
#: XLSTM_LAYERS layers, so that layer 6 is the pattern's sLSTM block
XLSTM_ARCH, XLSTM_LAYERS = "xlstm-125m", 8


def xlstm_config(get_config):
    """The xLSTM setting's config, from either package's ``get_config``."""
    import dataclasses
    return dataclasses.replace(get_config(XLSTM_ARCH).reduced(),
                               n_layers=XLSTM_LAYERS)


def _recurrent_module_cases(name, pd, fn, decode, cfg, seed, out, *,
                            lengths=SSM_LENGTHS):
    """One recurrent block ``fn`` (``fn(p, x, cfg, return_cache=...)``) on
    its params drawn from ``pd`` (``{name}/params``) and N(0, 1) inputs
    (``{name}/x{S}``, ``{name}/x_dec``): in f32 at each S of ``lengths``,
    in bf16 at the first (``{name}/{dt}/s{S}``), the output with and
    without a cache and the cache (``{out,out_nc,cache}``); at the first
    length the f32 gradients of ``sum(out · ct)`` for an N(0, 1) cotangent
    ``{name}/ct{S}``, as ``float32/s{S}/grads/{params/...,x}``; ``decode``
    of x_dec from the first length's cache (``{name}/{dt}/decode/{out,
    cache}``). The LM cases take the other lengths' gradients (33 tokens:
    ``_lm_f32_case``); each program compiled here costs the suite seconds."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    p32 = draw_params(pd, seed + 1)
    _flat(f"{name}/params", p32, out)
    xs = {S: rng.standard_normal((LM_BATCH, S, cfg.d_model))
          .astype(np.float32) for S in lengths}
    xd = rng.standard_normal((LM_BATCH, 1, cfg.d_model)).astype(np.float32)
    for S, x in xs.items():
        out[f"{name}/x{S}"] = x
    S = lengths[0]
    out[f"{name}/ct{S}"] = rng.standard_normal(xs[S].shape).astype(
        np.float32)
    gp, gx = jax.jit(jax.grad(lambda p, x, ct: jnp.sum(
        fn(p, x, cfg)[0] * ct), argnums=(0, 1)))(p32, xs[S],
                                                 out[f"{name}/ct{S}"])
    _flat(f"{name}/float32/s{S}/grads", {"params": gp, "x": gx}, out)
    out[f"{name}/x_dec"] = xd
    for dt, at in (("float32", lengths), ("bfloat16", lengths[:1])):
        p = jax.tree.map(lambda a: jnp.asarray(a, dt), p32)
        caches = {}
        for S in at:
            (o, caches[S]), (o_nc, _) = jax.jit(lambda p, x: (
                fn(p, x, cfg, return_cache=True), fn(p, x, cfg)))(
                    p, jnp.asarray(xs[S], dt))
            _flat(f"{name}/{dt}/s{S}", {"out": o, "out_nc": o_nc,
                                        "cache": caches[S]}, out)
        o, c = jax.jit(lambda p, x, c: decode(p, x, cfg, c))(
            p, jnp.asarray(xd, dt), caches[lengths[0]])
        _flat(f"{name}/{dt}/decode", {"out": o, "cache": c}, out)


def _lm_f32_case(base, params, toks, out, frames=None):
    """The LM wholly in f32: ``forward_train`` on the f32 params under
    ``_jax_f32_compute``, and the gradients of ``sum(logits ·
    ct)`` for an N(0, 1) cotangent: ``f32/{logits,ct,grads/...}``. With
    every matmul in f32 the two packages differ only by the order of f32
    sums, so this holds the whole LM's forward and backward tightly where
    the bf16 runs differ by amplified bf16 roundings. ``frames``: whisper's
    and the VLM's stub frames (the VLM's logits cover its prefix too)."""
    import jax
    import jax.numpy as jnp
    from repro.models import transformer

    batch = {"tokens": toks}
    if frames is not None:
        batch["frames"] = frames
    rows = toks.shape[1] + (base.encoder.n_frames if base.family == "vlm"
                            else 0)
    ct = np.random.default_rng(80).standard_normal(
        (toks.shape[0], rows, base.vocab_size)).astype(np.float32)

    def loss(p):
        logits, _ = transformer.forward_train(p, base, None, batch)
        return jnp.sum(logits * ct), logits
    with _jax_f32_compute():
        (_, logits), grads = jax.jit(jax.value_and_grad(
            loss, has_aux=True))(params)
    out["f32/ct"] = ct
    out["f32/logits"] = np.asarray(logits)
    _flat("f32/grads", jax.device_get(grads), out)


def mamba_cases():
    """The reduced zamba2-7b. (1) ``_recurrent_module_cases`` of
    ``mamba_parallel`` / ``mamba_decode`` (``mamba/...``). (2) The hybrid
    LM with ``mesh=None``: params (``params/...``), ``_lm_run`` with
    ``flash_attention`` False and True (the Pallas kernel in interpret
    mode; ``f{flash}/...``; the greedy tokens by ``generate``'s loop on
    its own programs, one decode program for both), ``_lm_f32_case``
    (``f32/...``) and ``_train_steps`` (``train/...``)."""
    import dataclasses

    import jax
    from repro.configs import get_config
    from repro.models import mamba as mb
    from repro.models.registry import build_model

    out = {}
    base = get_config(HYBRID_ARCH).reduced()
    _recurrent_module_cases("mamba", mb.mamba_pd(base), mb.mamba_parallel,
                            mb.mamba_decode, base, 50, out)
    params = lm_params(base)
    toks = lm_tokens(base)
    _flat("params", params, out)
    decode = jax.jit(lambda p, c, t, i: build_model(base).forward_decode(
        p, c, t, i, None))
    for flash in (0, 1):
        model = build_model(dataclasses.replace(base,
                                                flash_attention=bool(flash)))
        _flat(f"f{flash}", jax.device_get(_lm_run(
            model, params, toks, via_generate=False, decode=decode)), out)
    _lm_f32_case(base, params, toks, out)
    _train_steps(base, params, out)
    return out


def xlstm_cases():
    """The reduced xlstm-125m at XLSTM_LAYERS layers. (1)
    ``_recurrent_module_cases`` of ``mlstm_parallel`` / ``mlstm_decode``
    (``mlstm/...``) and of ``slstm_parallel`` / ``slstm_decode``
    (``slstm/...``, at the first length). (2) The xLSTM LM with
    ``mesh=None``: params (``params/...``), ``_lm_run`` (``f0/...``: the
    stack has no attention, so no flash case), ``_lm_f32_case``
    (``f32/...``) and ``_train_steps`` wholly in f32 (``train/...``: in
    bf16 the 8-layer stack's roundings part most tensors' updates from the
    reference's by more than LM_UPDATE_TOL)."""
    import jax
    from repro.configs import get_config
    from repro.models import xlstm as xl
    from repro.models.registry import build_model

    out = {}
    base = xlstm_config(get_config)
    _recurrent_module_cases("mlstm", xl.mlstm_pd(base), xl.mlstm_parallel,
                            xl.mlstm_decode, base, 60, out)
    _recurrent_module_cases("slstm", xl.slstm_pd(base), xl.slstm_parallel,
                            xl.slstm_decode, base, 70, out,
                            lengths=SSM_LENGTHS[:1])
    params = lm_params(base)
    toks = lm_tokens(base)
    _flat("params", params, out)
    _flat("f0", jax.device_get(_lm_run(build_model(base), params, toks,
                                       via_generate=False)), out)
    _lm_f32_case(base, params, toks, out)
    _train_steps(base, params, out, f32=True)
    return out


#: whisper-base reduced (d 256, 4 heads of 64, 2 decoder and 2 encoder
#: layers, 16 frames, d_ff 512, vocab 512) and internvl2-2b reduced (d 256,
#: 4 query heads on 2 kv heads of 64, 2 layers, an image prefix of 16
#: patch embeddings): the stub frames 0.02 · N(0, 1), as
#: ``data/synthetic`` draws them
WHISPER_ARCH, VLM_ARCH = "whisper-base", "internvl2-2b"


def lm_frames(cfg, seed=2):
    rng = np.random.default_rng(seed)
    return (0.02 * rng.standard_normal(
        (LM_BATCH, cfg.encoder.n_frames, cfg.d_model))).astype(np.float32)


def _whisper_module_cases(base, out):
    """The reference's whisper pieces, jitted, in f32 and bf16 on numpy
    draws: ``layer_norm`` (``ln/``), ``gelu_mlp_apply`` (``mlp/``) and the
    cross-attention, ``gqa_parallel(..., cross_x=enc, cache_len=Sk)``
    with ``flash_attention`` False and True (the Pallas kernel in
    interpret mode: non-causal, Sq 33 != Sk 16) and ``gqa_decode(...,
    cross=True)`` of one token from that cache (``cross/``)."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    from repro.models import attention, common, mlp

    rng = np.random.default_rng(90)
    d, S, F = base.d_model, LM_PROMPT + 1, base.encoder.n_frames
    x = rng.standard_normal((LM_BATCH, S, d)).astype(np.float32)
    enc = rng.standard_normal((LM_BATCH, F, d)).astype(np.float32)
    xd = rng.standard_normal((LM_BATCH, 1, d)).astype(np.float32)
    ln = {"scale": (1 + 0.1 * rng.standard_normal(d)).astype(np.float32),
          "bias": (0.1 * rng.standard_normal(d)).astype(np.float32)}
    mp = draw_params(mlp.gelu_mlp_pd(base), 91)
    ap = draw_params(attention.gqa_pd(base), 92)
    for name, v in (("x", x), ("enc", enc), ("x_dec", xd)):
        out[f"inputs/{name}"] = v
    _flat("ln/params", ln, out)
    _flat("mlp/params", mp, out)
    _flat("cross/params", ap, out)
    for dt in ("float32", "bfloat16"):
        c = lambda t, dt=dt: jax.tree.map(lambda a: jnp.asarray(a, dt), t)
        out[f"ln/{dt}"] = np.asarray(jax.jit(common.layer_norm)(
            c(x), c(ln["scale"]), c(ln["bias"])), np.float32)
        out[f"mlp/{dt}"] = np.asarray(jax.jit(mlp.gelu_mlp_apply)(
            c(mp), c(x)), np.float32)
        for flash in (0, 1):
            cfg = dataclasses.replace(base, flash_attention=bool(flash))
            o, cache = jax.jit(lambda p, h, e, cfg=cfg: attention.gqa_parallel(
                p, h, None, cfg, cross_x=e, cache_len=F))(c(ap), c(x),
                                                         c(enc))
            _flat(f"cross/{dt}/f{flash}", {"out": o, "cache": cache}, out)
        od, _ = jax.jit(lambda p, h, cc: attention.gqa_decode(
            p, h, 0, base, cc, cross=True))(c(ap), c(xd), cache)
        out[f"cross/{dt}/decode"] = np.asarray(od, np.float32)


def _frames_lm_cases(base, out, *, cache_len):
    """The LM with its stub frames, ``mesh=None``: params
    (``params/...``), the frames (``frames``), ``_lm_run`` with
    ``flash_attention`` False and True (one decode program for both;
    ``f{flash}/...``), ``_lm_f32_case`` (``f32/...``) and ``_train_steps``
    (``train/...``: the reference's own token batches, frames and all)."""
    import dataclasses

    import jax
    from repro.models.registry import build_model

    params = lm_params(base)
    toks = lm_tokens(base)
    frames = lm_frames(base)
    _flat("params", params, out)
    out["frames"] = frames
    decode = jax.jit(lambda p, c, t, i: build_model(base).forward_decode(
        p, c, t, i, None))
    for flash in (0, 1):
        model = build_model(dataclasses.replace(base,
                                                flash_attention=bool(flash)))
        _flat(f"f{flash}", jax.device_get(_lm_run(
            model, params, toks, cache_len=cache_len, via_generate=False,
            decode=decode, frames=frames)), out)
    _lm_f32_case(base, params, toks, out, frames=frames)
    _train_steps(base, params, out)


def whisper_cases():
    """The reduced whisper-base: ``_whisper_module_cases`` and
    ``_frames_lm_cases``."""
    from repro.configs import get_config

    out = {}
    base = get_config(WHISPER_ARCH).reduced()
    _whisper_module_cases(base, out)
    _frames_lm_cases(base, out, cache_len=LM_CACHE)
    return out


def vlm_cases():
    """The reduced internvl2-2b: ``_frames_lm_cases``, its cache holding
    the image prefix too; and the reference's ``_lm_loss`` and
    ``make_loss_fn`` metrics on the first training step's logits
    (``loss/...``: the labels left-padded with IGNORE over the prefix, the
    accuracy over all-IGNORE labels)."""
    import jax
    from repro.configs import get_config
    from repro.core.label_smoothing import top1_accuracy
    from repro.core.label_smoothing import IGNORE
    from repro.train.step import _lm_loss

    out = {}
    base = get_config(VLM_ARCH).reduced()
    _frames_lm_cases(base, out, cache_len=base.encoder.n_frames + LM_CACHE)
    rng = np.random.default_rng(95)
    logits = rng.standard_normal((LM_BATCH, base.encoder.n_frames
                                  + LM_PROMPT, base.vocab_size)).astype(
                                      np.float32)
    labels = rng.integers(0, base.vocab_size, (LM_BATCH, LM_PROMPT)) \
        .astype(np.int32)
    labels[:, -1] = IGNORE
    loss, n = jax.jit(lambda lg, lb: _lm_loss(lg, lb, smoothing=0.1))(
        logits, labels)
    acc = top1_accuracy(logits, np.full(logits.shape[:-1], IGNORE))
    _flat("loss", {"logits": logits, "labels": labels, "loss": loss,
                   "n": n, "acc": acc}, out)
    return out


#: the explicit-DP setting of the families added since the dense LM's: each
#: family's parity config (``family_config``) at LM_DP_BUCKET_MB, the cases
#: of ``LM_DP_CASES`` named here (zero3 with ``gather='per_group'``), LARS
#: poly2, the lcg batches of ``lm_train_steps`` (whisper's and the VLM's
#: with their threefry frames); the hybrid and the xLSTM wholly in f32 (f32
#: wire, ``_jax_f32_compute``), as their two-step training tests hold them
LM_FAMILY_DP = {HYBRID_ARCH: ("psum", "zero1", "zero3"),
                XLSTM_ARCH: ("psum", "zero1"),
                WHISPER_ARCH: ("psum", "zero1"),
                VLM_ARCH: ("psum", "zero1")}
LM_FAMILY_F32 = (HYBRID_ARCH, XLSTM_ARCH)


def family_config(get_config, arch):
    """The family's explicit-DP config, from either package's
    ``get_config``: the reduced config; the xLSTM's two layers an mLSTM
    and an sLSTM block (pattern ``("m", "s")``; the reduced config's
    pattern makes both mLSTM)."""
    import dataclasses
    cfg = get_config(arch).reduced()
    if arch == XLSTM_ARCH:
        cfg = dataclasses.replace(cfg, xlstm=dataclasses.replace(
            cfg.xlstm, pattern=("m", "s")))
    return cfg


def lm_family_dp_steps(archs):
    """``lm_dp_steps`` for each family of ``archs`` (a comma-separated
    subset of LM_FAMILY_DP): the reference's explicit step under the
    shard_map shim on a (1, 1) Auto-axis mesh, for each of the family's
    cases, two jitted steps along its own trajectory from ``lm_params``
    (``{arch}/params/...``), zero momentum and, on a sharded rung, the
    params packed into master shards. Per step the batch
    (``{arch}/s{k}/batch/...``) and, as ``{arch}/{case}/s{k}/...``, the
    metrics and the output state (step 0's input is the next step's: not
    saved): the params on the replicated rung, the packed master shards
    and momentum as ``{shards,mom}/{bucket}`` on a sharded one."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
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
    sched = make_schedule(ScheduleConfig(**LR))
    mesh = _mesh11()
    out, runs = {}, []
    # XLA compiles outside the interpreter lock: each program compiles in
    # a thread while the next one is traced
    pool = ThreadPoolExecutor(8)
    for arch in archs.split(","):
        base = family_config(get_config, arch)
        model = build_model(base)
        params = lm_params(base)
        _flat(f"{arch}/params", params, out)
        f32 = arch in LM_FAMILY_F32
        batches = [jax.device_get(token_batch(
            base, batch=LM_TRAIN_BATCH, seq=LM_TRAIN_SEQ, step=k,
            kind="lcg")) for k in range(LM_TRAIN_STEPS)]
        for k, batch in enumerate(batches):
            _flat(f"{arch}/s{k}/batch", batch, out)
        for case in LM_FAMILY_DP[arch]:
            strategy, sharding, gather = LM_DP_CASES[case]
            step = make_train_step(
                model, lars.OptConfig(kind="lars"), sched, mesh=mesh,
                comm=CommConfig(strategy=strategy, sharding=sharding,
                                gather=gather, bucket_mb=LM_DP_BUCKET_MB,
                                wire_dtype="f32" if f32 else "bf16"))
            plan = step.bucket_plan
            if sharding == "replicated":
                s = st.TrainState(jnp.zeros((), jnp.int32), params,
                                  jax.tree.map(np.zeros_like, params))
            else:
                s = st.TrainState(
                    jnp.zeros((), jnp.int32),
                    None if sharding == "zero3" else params,
                    st.init_packed_momentum(plan, 1), None,
                    st.init_packed_shards(params, plan, 1))
            s = jax.device_put(s, NamedSharding(mesh, P()))
            with _jax_f32_compute() if f32 else contextlib.nullcontext():
                lowered = jax.jit(step).lower(s, batches[0])
            runs.append((f"{arch}/{case}", sharding, s, batches,
                         pool.submit(lowered.compile)))
    compiled = [r[-1].result() for r in runs]
    pool.shutdown()
    for (key, sharding, s, batches, _), jstep in zip(runs, compiled):
        for k, batch in enumerate(batches):
            s, m = jstep(s, batch)
            pre = f"{key}/s{k}"
            x = jax.device_get(s)
            out[f"{pre}/out/step"] = np.asarray(x.step)
            if sharding == "replicated":
                _flat(f"{pre}/out/params", x.params, out)
                _flat(f"{pre}/out/mom", x.mom, out)
            else:
                for name in ("shards", "mom"):
                    for b, buf in enumerate(getattr(x, name)):
                        out[f"{pre}/out/{name}/{b}"] = np.asarray(buf)
            _flat(f"{pre}/metrics", jax.device_get(m), out)
    return out


def check_family_plan(arch, mesh):
    """``arch``'s explicit-DP config at LM_DP_BUCKET_MB in its wire dtype:
    the split leaves are exactly those wider than a bucket, each leaf's
    spans cover it in order, and its gradient lands where the plan says:
    the in-backward reduce-scatter of one rank (the sinks' shards, each
    group's identity firing once its leaves' cotangents are whole) equals
    the post-backward gradients packed into the plan, bit for bit. Returns
    the split leaves' paths."""
    import contextlib
    import math

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import bucketing, ddp, pinit, precision
    from repro_torch.data.synthetic import token_batch
    from repro_torch.models.registry import build_model
    from repro_torch.train.step import make_loss_fn
    from repro_torch.tree import tree_flatten, tree_unflatten

    base = family_config(get_config, arch)
    model = build_model(base)
    f32 = arch in LM_FAMILY_F32
    wire = torch.float32 if f32 else torch.bfloat16
    nbytes = 4 if f32 else 2
    plan = bucketing.make_plan(model.param_pd, bucket_mb=LM_DP_BUCKET_MB,
                               dtype_bytes=nbytes)
    flat = tree_flatten(model.param_pd)
    budget = int(LM_DP_BUCKET_MB * 2 ** 20 / nbytes)
    wide = {p for p, pd in flat
            if -(-math.prod(pd.shape) // bucketing.CHUNK) * bucketing.CHUNK
            > budget}
    split = {t[0].path for t in plan.tensor_slots if len(t) > 1}
    assert split == wide
    for spans in plan.tensor_slots:
        at = 0
        for s in spans:
            assert s.elem_offset == at
            at += s.size
        assert at == math.prod(spans[0].shape)
    params = pinit.materialize(model.param_pd, 0, "cpu")
    batch = token_batch(base, batch=2, seq=LM_TRAIN_SEQ, step=0,
                        device="cpu")
    loss = make_loss_fn(model)
    paths = [p for p, _ in tree_flatten(params)]
    with precision.f32_compute() if f32 else contextlib.nullcontext():
        sinks = ddp.make_shard_sinks(plan, 1)
        got = torch.autograd.grad(loss(ddp.wrap_params_for_overlap(
            params, plan, strategy="psum", axes=mesh.axes, comm_dtype=wire,
            shard_sinks=sinks), batch)[0], sinks)
        leaves = [x.detach().requires_grad_() for _, x in
                  tree_flatten(params)]
        raw = torch.autograd.grad(loss(tree_unflatten(paths, leaves),
                                       batch)[0], leaves)
    want = bucketing.pack(tree_unflatten(paths, raw), plan, dtype=wire)
    assert len(got) == len(want) == plan.n_buckets
    for b, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w.float()), b
    return split


def check_family_dp_step(r, arch, case, k, mesh, *, loss_rtol, update_tol):
    """The port's one-rank explicit step of ``case`` (LM_DP_CASES) on
    ``arch``'s explicit-DP config, from the reference's state before step
    ``k`` of ``lm_family_dp_steps`` (``r``) on its batch, against its
    output: the loss within ``loss_rtol`` relative, each tensor's new
    masters within ``update_tol`` of the reference's largest update
    element of that tensor, its momentum within ``update_tol`` of the
    reference's largest momentum element; the hybrid and the xLSTM wholly
    in f32 (``precision.f32_compute``, f32 wire), as the reference ran.
    Returns (loss relative difference, the worst masters figure, the worst
    momentum figure)."""
    import contextlib
    import types

    import torch
    from repro_torch import weights
    from repro_torch.configs import get_config
    from repro_torch.configs.base import CommConfig
    from repro_torch.core import lars, precision
    from repro_torch.core.schedule import ScheduleConfig, make_schedule
    from repro_torch.models.registry import build_model
    from repro_torch.train import state as st
    from repro_torch.train.loop import make_params_reader
    from repro_torch.tree import tree_flatten, tree_map
    from repro_torch.train.step import make_train_step

    base = family_config(get_config, arch)
    f32 = arch in LM_FAMILY_F32
    strategy, sharding, gather = LM_DP_CASES[case]
    step = make_train_step(
        build_model(base), lars.OptConfig(kind="lars"),
        make_schedule(ScheduleConfig(**LR)), mesh=mesh,
        comm=CommConfig(strategy=strategy, sharding=sharding, gather=gather,
                        bucket_mb=LM_DP_BUCKET_MB,
                        wire_dtype="f32" if f32 else "bf16"))
    assert step.sharding == sharding and step.n_shards == 1
    plan = step.bucket_plan
    bufs = lambda t: [torch.from_numpy(t[str(b)]) for b in range(len(t))]

    def to_state(x):
        if sharding == "replicated":
            return weights.lm_state_from_jax(types.SimpleNamespace(
                step=x["step"], params=x["params"], mom=x["mom"]), base,
                "cpu")
        return st.TrainState(int(x["step"]), None, bufs(x["mom"]), None,
                             bufs(x["shards"]))

    if k == 0:
        p0 = weights.lm_params_from_jax(r["params"], base, "cpu")
        state_in = (st.TrainState(0, p0, tree_map(torch.zeros_like, p0))
                    if sharding == "replicated" else st.TrainState(
                        0, None, st.init_packed_momentum(plan, 1), None,
                        st.init_packed_shards(p0, plan, 1)))
    else:
        state_in = to_state(r[case][f"s{k - 1}"]["out"])
    want_r = r[case][f"s{k}"]
    read = make_params_reader(step)
    tree = lambda t: dict(tree_flatten(weights.to_numpy(t)))
    p_in = tree(read(state_in))
    batch = {n: torch.from_numpy(v) for n, v in r[f"s{k}"]["batch"].items()}
    with precision.f32_compute() if f32 else contextlib.nullcontext():
        state, metrics = step(state_in, batch)
    want = to_state(want_r["out"])
    assert state.step == want.step == k + 1
    assert (state.params is None) == (sharding == "zero3")
    assert float(metrics["lr"]) == float(want_r["metrics"]["lr"])
    d_loss = abs(float(metrics["loss"]) - float(want_r["metrics"]["loss"])) \
        / abs(float(want_r["metrics"]["loss"]))
    mom = (lambda s: s.mom) if sharding == "replicated" else \
        (lambda s: st.full_params_from_shards(s.mom, plan))
    got_p, want_p = tree(read(state)), tree(read(want))
    got_m, want_m = tree(mom(state)), tree(mom(want))
    assert set(got_p) == set(want_p) == set(p_in) == set(got_m)
    of_upd = max((np.abs(got_p[n] - want_p[n]).max()
                  / max(np.abs(want_p[n] - p_in[n]).max(), 1e-30), n)
                 for n in want_p)
    of_mom = max((np.abs(got_m[n] - want_m[n]).max()
                  / max(np.abs(want_m[n]).max(), 1e-30), n) for n in want_m)
    assert d_loss <= loss_rtol, d_loss
    assert of_upd[0] <= update_tol, of_upd
    assert of_mom[0] <= update_tol, of_mom
    return d_loss, of_upd, of_mom


#: the model-axis parity setting (ROADMAP §1 item 6.2): an Auto-axis
#: (data 2, model 2) mesh of four host devices; the reduced qwen1.5-0.5b
#: (tied: its embedding splits the vocabulary) and qwen1.5-32b (untied,
#: QKV bias: its embedding splits d, its head the vocabulary)
TP_ARCHS = ("qwen1.5-0.5b", "qwen1.5-32b")
TP_MESH = (2, 2)


def _mesh_tp():
    import jax
    from jax.sharding import AxisType
    return jax.make_mesh(TP_MESH, ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


def _place(tree, pd_tree, mesh):
    """A numpy tree placed on ``mesh`` by the reference's descriptors'
    specs, as its ``pinit`` places params."""
    import jax
    from jax.sharding import NamedSharding
    return jax.tree.map(
        lambda x, pd: jax.device_put(x, NamedSharding(mesh, pd.spec)),
        tree, pd_tree)


def tp_cases():
    """The reference's GSPMD program on the (2, 2) mesh (``_mesh_tp``),
    its params placed by their specs, for each of ``TP_ARCHS``, in bf16
    (``f0``) and wholly in f32 (``f1``, ``_jax_f32_compute``): ``_lm_run``
    (greedy tokens from its own programs) and ``_train_steps`` (two
    ``comm='xla'`` steps; f32: ``comm_dtype='f32'``), as
    ``{arch}/f{f32}/{run,train}/...``, in f32 also two sgdm steps (a
    gradient scaled by a constant shows in their update, which LARS's
    trust ratio cancels), ``{arch}/sgdm/train/...``, the params as
    ``{arch}/params``;
    and once with ``flash_attention`` (the first arch in bf16: the Pallas
    kernel in interpret mode inside ``shard_map`` on each device's heads),
    ``flash/run/...``."""
    import dataclasses

    import jax
    from repro.configs import get_config
    from repro.models.registry import build_model

    _shard_map_shim()
    mesh = _mesh_tp()
    out = {}

    def case(arch, f32, key=None):
        base = get_config(arch).reduced()
        if key == "flash":
            base = dataclasses.replace(base, flash_attention=True)
        params = lm_params(base)
        model = build_model(base)
        mine = {}
        run = _lm_run(model, _place(params, model.param_pd, mesh),
                      lm_tokens(base), mesh=mesh, via_generate=False)
        _flat(f"{key or f'{arch}/f{f32}'}/run", jax.device_get(run), mine)
        if key is None:
            _flat(f"{arch}/params", params, mine)
            _train_steps(base, params, mine, f32=bool(f32), mesh=mesh,
                         prefix=f"{arch}/f{f32}/train")
            if f32:
                _train_steps(base, params, mine, f32=True, mesh=mesh,
                             prefix=f"{arch}/sgdm/train", kind="sgdm")
        return mine

    # the cases of one dtype in threads (XLA compiles outside the
    # interpreter lock); the f32 ones under one _jax_f32_compute, which
    # patches the module globals their tracing reads
    for f32 in (0, 1):
        jobs = [(arch, f32) for arch in TP_ARCHS]
        if not f32:
            jobs.append((TP_ARCHS[0], 0, "flash"))
        with _jax_f32_compute() if f32 else contextlib.nullcontext(), \
                ThreadPoolExecutor(len(jobs)) as pool:
            for done in [pool.submit(case, *job) for job in jobs]:
                out.update(done.result())
    return out


#: the model axis for whisper and the VLM (ROADMAP §1 item 6.2c): their
#: reduced configs on ``_mesh_tp``, in bf16 and wholly in f32
TP_FRAMES_ARCHS = (WHISPER_ARCH, VLM_ARCH)
#: attention heads that the model axis does not divide (item 6.2c, the
#: reference's ``pin`` false case), the reduced qwen1.5-0.5b wholly in f32:
#: MQA (one kv head over model 2) on ``_mesh_tp``, and two heads over
#: model 4 (half a head a rank) on a (1, 4) mesh
TP_HEAD_CASES = {"mqa": ((2, 2), {"n_kv_heads": 1}),
                 "h2m4": ((1, 4), {"n_heads": 2, "n_kv_heads": 2})}


def tp_case_config(get_config, name):
    """The config of a ``tp_frames_cases`` case, from either package's
    ``get_config``: a frames arch reduced, or a ``TP_HEAD_CASES`` one."""
    import dataclasses
    if name in TP_HEAD_CASES:
        return dataclasses.replace(get_config(LM_ARCH).reduced(),
                                   **TP_HEAD_CASES[name][1])
    return get_config(name).reduced()


def tp_case_cache(cfg) -> int:
    """``_lm_run``'s cache rows for ``cfg``: the VLM's count its prefix."""
    return LM_CACHE + (cfg.encoder.n_frames if cfg.family == "vlm" else 0)


def tp_frames_cases():
    """The reference's GSPMD program, its params placed by their specs:
    each of ``TP_FRAMES_ARCHS`` on ``_mesh_tp`` in bf16 (``f0``) and
    wholly in f32 (``f1``), and each of ``TP_HEAD_CASES`` on its mesh in
    f32: ``_lm_run`` with the stub frames (``lm_frames``; greedy tokens
    from its own programs) and two LARS ``comm='xla'`` steps
    (``_train_steps``; the reference's token batches carry the frames), as
    ``{name}/f{f32}/{run,train}/...``, the params as ``{name}/params``.
    Each program runs in a thread of its own."""
    import jax
    from jax.sharding import AxisType
    from repro.configs import get_config
    from repro.models.registry import build_model

    _shard_map_shim()
    meshes = {TP_MESH: _mesh_tp(),
              (1, 4): jax.make_mesh((1, 4), ("data", "model"),
                                    axis_types=(AxisType.Auto,) * 2)}

    def case(name, f32):
        base = tp_case_config(get_config, name)
        mesh = meshes[TP_HEAD_CASES[name][0] if name in TP_HEAD_CASES
                      else TP_MESH]
        params = lm_params(base)
        model = build_model(base)
        frames = lm_frames(base) if base.encoder is not None else None
        mine = {}
        run = _lm_run(model, _place(params, model.param_pd, mesh),
                      lm_tokens(base), mesh=mesh, via_generate=False,
                      frames=frames, cache_len=tp_case_cache(base))
        _flat(f"{name}/f{f32}/run", jax.device_get(run), mine)
        _flat(f"{name}/params", params, mine)
        _train_steps(base, params, mine, f32=bool(f32), mesh=mesh,
                     prefix=f"{name}/f{f32}/train")
        return mine

    out = {}
    for f32 in (0, 1):
        jobs = [(a, f32) for a in TP_FRAMES_ARCHS]
        if f32:
            jobs += [(c, 1) for c in TP_HEAD_CASES]
        with _jax_f32_compute() if f32 else contextlib.nullcontext(), \
                ThreadPoolExecutor(len(jobs)) as pool:
            for done in [pool.submit(case, *job) for job in jobs]:
                out.update(done.result())
    return out


#: the MoE layer's experts over the model axis (ROADMAP §1 item 6.3): name
#: -> (the MOE_CASES case, mesh, tokens a row or None for MOE_S). "cap"
#: and "pad" on ``_mesh_tp``; "pad4" on a (1, 4) mesh (8 of the 32 padded
#: experts a rank: rank 2 holds 4 padded ones, rank 3 only padded ones);
#: "cap1" at one token a row on (2, 2), S < M: the local-psum branch in
#: train too
TP_MOE_LAYERS = {"cap": ("cap", TP_MESH, None), "pad": ("pad", TP_MESH, None),
                 "pad4": ("pad", (1, 4), None), "cap1": ("cap", TP_MESH, 1)}


#: ``tp_moe_cases``' two parts, each its own subprocess (they patch the
#: same module globals while tracing, so they do not share one in threads)
TP_MOE_PARTS = ("layers", "lm")


def tp_moe_cases(part):
    """The reference's MoE over the model axis, under the shard_map shim.
    ``layers``: ``_moe_layer_case`` for each of ``TP_MOE_LAYERS`` on its
    mesh (the inputs of ``moe_cases``' case; ``{name}/...``, each device's
    FFN buffers as ``xs/d{i}m{j}``). ``lm``: the reduced
    qwen2-moe-a2.7b's GSPMD program on ``_mesh_tp``, its params placed by
    their specs, in bf16 (``f0``) and wholly in f32 (``f1``): ``_lm_run``
    (the full forward over the prompt, which model 2 divides; greedy
    tokens from its own programs) and two LARS ``comm='xla'`` steps with
    each layer's expert ids a device (``_train_steps(routes=True)``), as
    ``lm/f{f32}/{run,train}/...``, the params as ``lm/params``."""
    import jax
    from jax.sharding import AxisType
    from repro.configs import get_config
    from repro.models.registry import build_model

    _shard_map_shim()
    meshes = {TP_MESH: _mesh_tp(),
              (1, 4): jax.make_mesh((1, 4), ("data", "model"),
                                    axis_types=(AxisType.Auto,) * 2)}
    out = {}
    if part == "layers":
        for name, (case, mesh, seq) in TP_MOE_LAYERS.items():
            _moe_layer_case(moe_case_cfg(get_config, case),
                            10 + list(MOE_CASES).index(case), name,
                            meshes[mesh], out, grads=True, seq=seq,
                            route=False)
        return out
    base = get_config(MOE_ARCH).reduced()
    params = lm_params(base)
    model = build_model(base)
    mesh = meshes[TP_MESH]
    _flat("lm/params", params, out)
    for f32 in (0, 1):
        with _jax_f32_compute() if f32 else contextlib.nullcontext():
            run = _lm_run(model, _place(params, model.param_pd, mesh),
                          lm_tokens(base), mesh=mesh, via_generate=False,
                          train_len=LM_PROMPT)
        _flat(f"lm/f{f32}/run", jax.device_get(run), out)
        _train_steps(base, params, out, f32=bool(f32), mesh=mesh,
                     prefix=f"lm/f{f32}/train", routes=True)
    return out


#: MLA over the model axis (ROADMAP §1 item 6.3's MLA part): the reduced
#: deepseek-v2-236b's MLA block (4 heads) by name -> mesh: "m2" on
#: ``_mesh_tp`` (with its f32 gradients and the flash prefill in bf16),
#: "m4" on a (1, 4) mesh (one head a rank); its LM on ``_mesh_tp`` and its
#: f32 steps on a (4, 1) mesh (data ranks alone)
TP_MLA_BLOCKS = {"m2": TP_MESH, "m4": (1, 4)}
TP_MLA_DP = (4, 1)
#: ``tp_mla_cases``' parts, each its own subprocess, run at once (they
#: patch the same module globals while tracing, so they do not share one
#: in threads)
TP_MLA_PARTS = ("block", "run", "train0", "train1")


def _mla_block_case(cfg, mesh, prefix, out, *, extra):
    """The MLA block of ``mla_cases``' inputs (``mla/params``, ``mla/x``,
    ``mla/x_dec``: seeds 31 and 30) on ``mesh``, its params placed by
    their specs, x over ``data``, in f32 and bf16: ``mla_parallel`` (out
    and the latent cache of LM_CACHE rows) and, from that cache (placed
    as ``cache_pd`` places it), ``mla_decode`` of ``x_dec`` at position
    LM_PROMPT, as ``{prefix}/{dt}/{prefill,decode}/...`` (the inputs as
    ``inputs/...``). With ``extra``:
    the flash prefill in bf16 (the Pallas kernel in interpret mode inside
    ``shard_map`` on each device's heads), ``{prefix}/bfloat16/flash``,
    and the f32 gradients of ``sum(out · ct)`` w.r.t. the params and x,
    ``{prefix}/grads/...`` (``ct`` N(0, 1), seed 33)."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P
    from repro.models import attention as attn

    pd = attn.mla_pd(cfg)
    rng = np.random.default_rng(30)
    p32 = draw_params(pd, 31)
    x32 = rng.standard_normal((LM_BATCH, LM_PROMPT, cfg.d_model)) \
        .astype(np.float32)
    xd32 = rng.standard_normal((LM_BATCH, 1, cfg.d_model)).astype(np.float32)
    _flat("inputs", {"params": p32, "x": x32, "x_dec": xd32}, out)
    rows = lambda a: jax.device_put(a, NamedSharding(mesh, P("data")))
    positions = jnp.arange(LM_PROMPT)[None]
    pos = jnp.int32(LM_PROMPT)
    for dt in ("float32", "bfloat16"):
        p = _place(jax.tree.map(lambda a: jnp.asarray(a, dt), p32), pd, mesh)
        x, xd = rows(jnp.asarray(x32, dt)), rows(jnp.asarray(xd32, dt))
        o, cache = jax.jit(lambda p, x: attn.mla_parallel(
            p, x, positions, cfg, cache_len=LM_CACHE, mesh=mesh))(p, x)
        _flat(f"{prefix}/{dt}/prefill", jax.device_get(
            {"out": o, "cache": cache}), out)
        o, c2 = jax.jit(lambda p, x, c, i: attn.mla_decode(
            p, x, i, cfg, c))(p, xd, jax.tree.map(rows, cache), pos)
        _flat(f"{prefix}/{dt}/decode", jax.device_get(
            {"out": o, "cache": c2}), out)
        if extra and dt == "bfloat16":
            fc = dataclasses.replace(cfg, flash_attention=True)
            o, _ = jax.jit(lambda p, x: attn.mla_parallel(
                p, x, positions, fc, mesh=mesh))(p, x)
            out[f"{prefix}/{dt}/flash"] = np.asarray(o, np.float32)
        if extra and dt == "float32":
            ct = np.random.default_rng(33).standard_normal(
                (LM_BATCH, LM_PROMPT, cfg.d_model)).astype(np.float32)
            out[f"{prefix}/ct"] = ct

            def loss(p, x):
                o, _ = attn.mla_parallel(p, x, positions, cfg, mesh=mesh)
                return jnp.sum(o * ct)
            gp, gx = jax.jit(jax.grad(loss, (0, 1)))(p, x)
            _flat(f"{prefix}/grads", jax.device_get(gp), out)
            out[f"{prefix}/grads/x"] = np.asarray(gx)


def tp_mla_cases(part):
    """The reference's MLA over the model axis, under the shard_map shim
    (its MoE layer and flash path run in ``shard_map``). ``block``:
    ``_mla_block_case`` for each of ``TP_MLA_BLOCKS`` (``{name}/...``).
    ``run`` and ``train{f32}``: the reduced deepseek-v2-236b's GSPMD
    program on ``_mesh_tp``, its params placed by their specs
    (``lm/params``), in bf16 (``f0``) and wholly in f32 (``f1``): ``run``,
    ``_lm_run`` (the full forward over the prompt, which model 2 divides;
    greedy tokens from its own programs), ``lm/f{f32}/run/...``;
    ``train{f32}``, two LARS ``comm='xla'`` steps with each layer's expert
    ids a device (``_train_steps(routes=True)``), ``lm/f{f32}/train/...``,
    and in ``train1`` two f32 steps on the (4, 1) mesh (``TP_MLA_DP``),
    ``dp/train/...``."""
    import jax
    from jax.sharding import AxisType
    from repro.configs import get_config
    from repro.models.registry import build_model

    _shard_map_shim()
    mesh_of = lambda shape: jax.make_mesh(shape, ("data", "model"),
                                          axis_types=(AxisType.Auto,) * 2)
    base = get_config(MLA_ARCH).reduced()
    out = {}
    if part == "block":
        for name, shape in TP_MLA_BLOCKS.items():
            _mla_block_case(base, mesh_of(shape), name, out,
                            extra=shape == TP_MESH)
        return out
    params = lm_params(base)
    model = build_model(base)
    mesh = mesh_of(TP_MESH)
    if part != "run":
        f32 = part == "train1"
        _train_steps(base, params, out, f32=f32, mesh=mesh,
                     prefix=f"lm/f{int(f32)}/train", routes=True)
        if f32:
            _train_steps(base, params, out, f32=True,
                         mesh=mesh_of(TP_MLA_DP), prefix="dp/train")
        return out
    _flat("lm/params", params, out)
    for f32 in (0, 1):
        with _jax_f32_compute() if f32 else contextlib.nullcontext():
            run = _lm_run(model, _place(params, model.param_pd, mesh),
                          lm_tokens(base), mesh=mesh, via_generate=False,
                          train_len=LM_PROMPT)
        _flat(f"lm/f{f32}/run", jax.device_get(run), out)
    return out


#: the model axis for the recurrent families (ROADMAP §1 item 6.2b): the
#: reduced zamba2-7b and the xLSTM (``tp_config``) on ``_mesh_tp``, wholly
#: in f32
TP_RECURRENT_ARCHS = (HYBRID_ARCH, XLSTM_ARCH)
#: the xLSTM's width over the model axis: at the reduced d 256 its sLSTM
#: FFN is int(4/3 · 256) = 341 wide, which model 2 does not divide (and
#: the reference cannot place, as the port refuses it); 192 gives 256 (the
#: full 768 gives 1,024), with the reduced config's 4 heads
TP_XLSTM_D = 192
#: the second moment the LAMB step starts from: from zero moments its first
#: update is g / (|g| + eps), the sign of each gradient element, which
#: rounding flips where a gradient cancels to noise; from v0 > 0 it is
#: proportional to the gradient, as every later step's is
LAMB_V0 = 1e-4


def tp_config(get_config, arch):
    """The model-axis parity config of a recurrent family, from either
    package's ``get_config``: ``family_config`` (the xLSTM's mLSTM and
    sLSTM block), the xLSTM at d ``TP_XLSTM_D``."""
    import dataclasses
    cfg = family_config(get_config, arch)
    if arch == XLSTM_ARCH:
        cfg = dataclasses.replace(cfg, d_model=TP_XLSTM_D)
    return cfg


def _step_io(step, s, batch, pre, out, *args):
    """One jitted step from ``s`` on ``batch``: its input and output
    states, batch and metrics as ``{pre}/{in,out,batch,metrics}/...``.
    Returns the output state."""
    import jax
    s2, m = step(s, batch, *args)
    for io, x in (("in", s), ("out", s2)):
        x = jax.device_get(x)
        out[f"{pre}/{io}/step"] = np.asarray(x.step)
        _flat(f"{pre}/{io}/params", x.params, out)
        _flat(f"{pre}/{io}/mom", x.mom, out)
    _flat(f"{pre}/batch", batch, out)
    _flat(f"{pre}/metrics", jax.device_get(m), out)
    return s2


def tp_recurrent_cases():
    """The reference's GSPMD program on the (2, 2) mesh (``_mesh_tp``) for
    each of ``TP_RECURRENT_ARCHS``, wholly in f32 (``_jax_f32_compute``),
    its params placed by their specs: ``_lm_run`` (greedy tokens from its
    own programs), two LARS and two sgdm ``comm='xla'`` steps
    (``_train_steps``, f32 wire), as ``{arch}/{run,train,sgdm}/...``, the
    params as ``{arch}/params``; for the hybrid also one LAMB step
    (``{arch}/lamb``, from m = 0 and v = LAMB_V0, placed by the params'
    specs) and the
    guarded LARS step (``guard=True``) from the same input twice, with
    ``neutral_inputs()`` (``{arch}/guard/ok``) and with an infinite
    ``loss_scale`` (``{arch}/guard/bad``: the step it skips). Each of
    these programs runs in a thread of its own."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.core import lars
    from repro.core.schedule import ScheduleConfig, make_schedule
    from repro.data.synthetic import token_batch
    from repro.models.registry import build_model
    from repro.train import guard as guard_lib
    from repro.train.state import TrainState
    from repro.train.step import make_train_step

    _shard_map_shim()
    mesh = _mesh_tp()

    def case(arch, what):
        base = tp_config(get_config, arch)
        params = lm_params(base)
        model = build_model(base)
        mine = {}
        placed = _place(params, model.param_pd, mesh)
        if what == "run":
            _flat(f"{arch}/params", params, mine)
            _flat(f"{arch}/run", jax.device_get(_lm_run(
                model, placed, lm_tokens(base), mesh=mesh,
                via_generate=False)), mine)
        elif what in ("lars", "sgdm"):
            _train_steps(base, params, mine, f32=True, mesh=mesh,
                         prefix=f"{arch}/{'train' if what == 'lars' else what}",
                         kind=what)
        sched = make_schedule(ScheduleConfig(**LR))
        batch = jax.device_get(token_batch(
            base, batch=LM_TRAIN_BATCH, seq=LM_TRAIN_SEQ, step=0,
            kind="lcg"))
        step0 = jnp.zeros((), jnp.int32)
        if what == "lamb":
            mom = lars.init_momentum(params, "lamb")
            mom = {"m": _place(jax.device_get(mom["m"]), model.param_pd,
                               mesh),
                   "v": _place(jax.tree.map(
                       lambda p: np.full_like(p, LAMB_V0), params),
                       model.param_pd, mesh),
                   "count": mom["count"]}
            lamb = jax.jit(make_train_step(
                model, lars.OptConfig(kind="lamb"), sched, mesh=mesh,
                comm="xla", comm_dtype="f32"))
            _step_io(lamb, TrainState(step0, placed, mom), batch,
                     f"{arch}/lamb", mine)
        elif what == "guard":
            guarded = jax.jit(make_train_step(
                model, lars.OptConfig(kind="lars"), sched, mesh=mesh,
                comm="xla", comm_dtype="f32", guard=True))
            s = TrainState(step0, placed, _place(
                jax.tree.map(np.zeros_like, params), model.param_pd, mesh))
            for name, scale in (("ok", 1.0), ("bad", np.inf)):
                _step_io(guarded, s, batch, f"{arch}/guard/{name}", mine,
                         dict(guard_lib.neutral_inputs(),
                              loss_scale=np.float32(scale)))
        return mine

    jobs = [(arch, what) for arch in TP_RECURRENT_ARCHS
            for what in ("run", "lars", "sgdm")
            + (("lamb", "guard") if arch == HYBRID_ARCH else ())]
    out = {}
    # XLA compiles outside the interpreter lock: a thread a program
    with _jax_f32_compute(), ThreadPoolExecutor(len(jobs)) as pool:
        for done in [pool.submit(case, *job) for job in jobs]:
            out.update(done.result())
    return out


#: ResNet-50 under ``comm='xla'`` over several ranks (ROADMAP §1 item
#: 6.2b): the reduced config on an Auto-axis (data 2, model 1) mesh of two
#: host devices, each ``sync_bn`` form, XLA_CONV_STEPS steps
XLA_CONV_STEPS = 2


def xla_conv_cases():
    """The reduced ResNet-50 (``_init``'s damped params) on the (2, 1)
    mesh, its batches (``_batch``) placed over ``data``, for ``sync_bn``
    0 and 1 (``s{sync}/...``): the bf16 forward over the mesh with its
    gradients w.r.t. the bf16 copy (``fwd/{logits,new_bn,grads}``; step
    0's batch), and XLA_CONV_STEPS jitted ``comm='xla'`` LARS steps along
    the reference's own trajectory (``s{k}/...``: ``_state``'s input and
    output states, batch and metrics). The params and BN state as
    ``params`` and ``bn``. Each program compiles in a thread of its
    own. ``bn/...``: one BatchNorm with ``sync_bn`` on a one-device
    (1, 1) mesh (its input ``x`` (4, 5, 5, 8) f32, params and running
    state; ``y`` and ``st`` out)."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType, NamedSharding
    from jax.sharding import PartitionSpec as P
    from repro.configs import get_config
    from repro.core import lars
    from repro.core.label_smoothing import smoothed_xent
    from repro.core.precision import cast_to_compute
    from repro.core.schedule import ScheduleConfig, make_schedule
    from repro.models import resnet
    from repro.models.registry import build_model
    from repro.train.state import TrainState
    from repro.train.step import make_train_step

    _shard_map_shim()
    mesh = jax.make_mesh((2, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    rows = NamedSharding(mesh, P("data"))
    base = get_config("resnet50").reduced()
    params, bn = _init(base)
    out = {}
    _flat("params", params, out)
    _flat("bn", bn, out)

    def case(sync, what):
        cfg = dataclasses.replace(base, sync_bn=bool(sync))
        mine = {}

        def loss(p, imgs, labels):
            logits, new_bn = resnet.resnet_forward(p, bn, cfg, imgs,
                                                   train=True, mesh=mesh)
            return smoothed_xent(logits, labels)[0], (logits, new_bn)

        if what == "fwd":
            b0 = _batch(cfg, 0)
            (_, (logits, new_bn)), grads = jax.jit(jax.value_and_grad(
                loss, has_aux=True))(cast_to_compute(params),
                                     jax.device_put(b0["images"], rows),
                                     jax.device_put(b0["labels"], rows))
            _flat(f"s{sync}/fwd", jax.device_get(
                {"logits": logits, "new_bn": new_bn, "grads": grads}), mine)
            return mine
        step = jax.jit(make_train_step(
            build_model(cfg), lars.OptConfig(),
            make_schedule(ScheduleConfig(**LR)), mesh=mesh, comm="xla"))
        s = TrainState(jnp.zeros((), jnp.int32), params,
                       jax.tree.map(np.zeros_like, params), bn)
        for k in range(XLA_CONV_STEPS):
            batch = _batch(cfg, k)
            s2, m = step(s, {n: jax.device_put(v, rows)
                             for n, v in batch.items()})
            pre = f"s{sync}/s{k}"
            _state(f"{pre}/in", jax.device_get(s), mine)
            _flat(f"{pre}/batch", batch, mine)
            _state(f"{pre}/out", jax.device_get(s2), mine)
            _flat(f"{pre}/metrics", jax.device_get(m), mine)
            # placed as step 0's input was, so the program is reused
            s = jax.device_get(s2)
            s = TrainState(jnp.asarray(s.step), s.params, s.mom, s.bn_state)
        return mine

    # XLA compiles outside the interpreter lock: a thread a program
    jobs = [(sync, what) for sync in (0, 1) for what in ("fwd", "steps")]
    with ThreadPoolExecutor(len(jobs)) as pool:
        for done in [pool.submit(case, *job) for job in jobs]:
            out.update(done.result())

    one = jax.make_mesh((1, 1), ("data", "model"),
                        axis_types=(AxisType.Auto,) * 2,
                        devices=jax.devices()[:1])
    rng = np.random.default_rng(90)
    x = rng.standard_normal((4, 5, 5, 8)).astype(np.float32)
    p = {"scale": 1 + 0.1 * rng.standard_normal(8).astype(np.float32),
         "bias": 0.1 * rng.standard_normal(8).astype(np.float32)}
    st = {"mean": 0.1 * rng.standard_normal(8).astype(np.float32),
          "var": 1 + 0.1 * rng.random(8).astype(np.float32)}
    y, st2 = jax.jit(lambda x: resnet._bn(x, p, st, train=True,
                                          momentum=0.9, mesh=one,
                                          sync=True))(x)
    _flat("bn1", {"x": x, "p": p, "st": st, "y": y, "st_out": st2}, out)
    return out


if __name__ == "__main__":
    what, dest = sys.argv[1], sys.argv[2]
    what, _, arg = what.partition(":")
    if what in ("lm_family_dp_steps", "tp_moe_cases", "tp_mla_cases"):
        np.savez(dest, **globals()[what](arg))
        sys.exit()
    np.savez(dest, **{"resnet_grads": resnet_grads,
                      "train_steps": train_steps,
                      "zero1_steps": zero1_steps,
                      "zero23_steps": zero23_steps,
                      "comm_shards": comm_shards,
                      "attention_cases": attention_cases,
                      "lm_cases": lm_cases,
                      "lm_train_steps": lm_train_steps,
                      "lm_dp_steps": lm_dp_steps,
                      "moe_cases": moe_cases,
                      "mla_cases": mla_cases,
                      "lm_variant_cases": lm_variant_cases,
                      "mamba_cases": mamba_cases,
                      "xlstm_cases": xlstm_cases,
                      "whisper_cases": whisper_cases,
                      "vlm_cases": vlm_cases,
                      "guard_zero1_run": guard_zero1_run,
                      "traced_zero1_step": traced_zero1_step,
                      "tp_cases": tp_cases,
                      "tp_recurrent_cases": tp_recurrent_cases,
                      "tp_frames_cases": tp_frames_cases,
                      "xla_conv_cases": xla_conv_cases}[what]())
