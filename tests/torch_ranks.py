"""Multi-rank checks of the port's explicit data parallelism, on gloo.

``launch(scenario, n, out_dir)`` starts ``n`` processes of this file, one
rank each (``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT``,
as ``torchrun`` sets them), waits for all of them, and returns each rank's
results, which every rank saves to ``out_dir/rank{r}.npz``. A scenario
asserts what it can see from inside a rank; the test compares across
ranks and with the reference. The tests run the ranks on the CPU over
gloo; ``device="cuda"`` runs them one card each over NCCL.

  python tests/torch_ranks.py SCENARIO OUT_DIR cpu|cuda   (env above)
"""
import contextlib
import os
import socket
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-6


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(scenario: str, n: int, out_dir: str, timeout: int = 300,
           device: str = "cpu"):
    env = dict(os.environ, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), WORLD_SIZE=str(n),
               PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"),
                                           os.path.join(ROOT, "tests")]),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), scenario, out_dir,
         device],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(n)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    bad = [(r, p.returncode, log[-3000:])
           for r, (p, log) in enumerate(zip(procs, logs)) if p.returncode]
    assert not bad, bad
    out = []
    for r in range(n):
        with np.load(os.path.join(out_dir, f"rank{r}.npz")) as z:
            out.append({k: z[k] for k in z.files})
    return out


# ----------------------------------------------------------- scenarios

def _maxdiff(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


#: every schedule of the port; naive has only the post-backward all-reduce
STRATEGIES = ("naive", "psum", "bucketed", "ring", "hierarchical",
              "2d_torus", "dbtree")


def comm_meshes(world: int, device=None):
    """The meshes the schedules run on, by name: the flat ``(data,)``, the
    trailing-trivial ``(data, model=1)`` and, on four ranks, the
    ``(pod 2, data 2)`` mesh (``torch_reference.COMM_MESHES``)."""
    from repro_torch.launch.mesh import make_mesh
    meshes = {"flat": make_mesh((world,), ("data",), device=device),
              "dm": make_mesh((world, 1), ("data", "model"), device=device)}
    if world == 4:
        meshes["pod"] = make_mesh((2, 2), ("pod", "data"), device=device)
    return meshes


def schedules(mesh):
    """Every schedule, with ``use_kernel`` both ways, post-backward and
    in-backward, all-reduce and reduce-scatter forms, on every mesh of
    ``comm_meshes``, against the naive mean of the ranks' gradients (rank
    r's are ``tree * (1 + 0.1 r)``), f32 wire. The kernel flag must not
    change a bit of a reduce-scatter. Returns the reduce-scatter shards
    (``{mesh}/{strategy}/k{kernel}/{bucket}``) for the cross-rank and
    reference checks."""
    import torch
    import torch_reference
    from repro_torch.comm.schedules import shard_axis
    from repro_torch.core import bucketing, ddp
    from repro_torch.tree import tree_flatten, tree_map, tree_unflatten

    n, r = mesh.size, mesh.rank
    tree = tree_map(lambda x: torch.from_numpy(x).to(mesh.device),
                    torch_reference.comm_tree())
    plan = bucketing.make_plan(tree, bucket_mb=torch_reference.COMM_BUCKET_MB)
    assert any(s.elem_offset for s in plan.slots)      # a split tensor
    paths = plan.paths
    g_r = tree_map(lambda x: x * (1.0 + 0.1 * r), tree)
    naive = tree_map(lambda x: (x.double() * sum(1.0 + 0.1 * q
                                                 for q in range(n)) / n)
                     .float(), tree)
    naive_bufs = bucketing.pack(naive, plan, dtype=torch.float32)

    def local_loss(p):
        return sum((torch.sin(x * (1.0 + 0.1 * r)) * x).sum()
                   for _, x in tree_flatten(p))

    out = {}
    for mname, m in comm_meshes(n, mesh.device).items():
        axes, sh = m.axes, shard_axis(m.axes)
        # this rank's chunk of the packed, rotated naive mean
        naive_rows = [bucketing.rotate_to_shards(b, sh.size)
                      .reshape(sh.size, -1)[sh.index] for b in naive_bufs]
        for strategy in STRATEGIES:
            first = None
            for kernel in (False, True):
                kw = dict(strategy=strategy, axes=axes,
                          comm_dtype=torch.float32, use_kernel=kernel)
                where = (mname, strategy, kernel)
                # post-backward all-reduce
                red = ddp.allreduce_grads(g_r, plan=plan, **kw)
                for (p, a), (_, b) in zip(tree_flatten(red),
                                          tree_flatten(naive)):
                    assert _maxdiff(a, b) <= TOL, (where, "allreduce", p)
                if strategy == "naive":
                    break
                # in-backward all-reduce: d/dp sum(p * g_r) = g_r
                leaves = [x.clone().requires_grad_()
                          for _, x in tree_flatten(tree)]
                wrapped = ddp.wrap_params_for_overlap(
                    tree_unflatten(paths, leaves), plan, **kw)
                loss = sum((x * g).sum() for (_, x), (_, g) in
                           zip(tree_flatten(wrapped), tree_flatten(g_r)))
                for x, (p, b) in zip(torch.autograd.grad(loss, leaves),
                                     tree_flatten(naive)):
                    assert _maxdiff(x, b) <= TOL, (where, "overlap", p)
                # post-backward reduce-scatter: this rank's chunk
                shards = ddp.reduce_scatter_grads(g_r, plan=plan, **kw)
                for b, (a, w) in enumerate(zip(shards, naive_rows)):
                    assert _maxdiff(a, w) <= TOL, (where, "rs", b)
                    out[f"{mname}/{strategy}/k{int(kernel)}/{b}"] = \
                        a.cpu().numpy()
                # in-backward reduce-scatter (gradient sinks) ==
                # post-backward
                sinks = ddp.make_shard_sinks(plan, sh.size,
                                             device=mesh.device)
                got = torch.autograd.grad(local_loss(
                    ddp.wrap_params_for_overlap(tree, plan,
                                                shard_sinks=sinks, **kw)),
                    sinks)
                leaves = [x.clone().requires_grad_()
                          for _, x in tree_flatten(tree)]
                grads = torch.autograd.grad(
                    local_loss(tree_unflatten(paths, leaves)), leaves)
                want = ddp.reduce_scatter_grads(
                    tree_unflatten(paths, grads), plan=plan, **kw)
                for b, (a, w) in enumerate(zip(got, want)):
                    assert _maxdiff(a, w) <= TOL, (where, "in-bwd rs", b)
                if first is None:
                    first = shards
                    continue
                # the reduce-scatter forms cut the same CHUNK-aligned
                # chunks either way, so the fold (K3's plain version on
                # the CPU) sums in the same order: the same bits. (The
                # all-reduce forms pad to CHUNK only with the kernel, so
                # their chunks, and beyond two ranks their sums' order,
                # may differ: held to TOL above.)
                assert all(torch.equal(a, b)
                           for a, b in zip(shards, first)), where
    return out


#: (schedule, overlap, update_kernel) of the 2-rank ZeRO-1 check
ZERO1_CASES = (("psum", False, False), ("psum", True, True),
               ("ring", True, False), ("ring", False, True))


#: (sharding, gather, schedule, overlap, update_kernel, use_kernel) of the
#: 2-rank zero2 / zero3 check: each rung, gather mode and factor both
#: ways, over five schedules
ZERO23_CASES = (("zero2", None, "ring", True, True, True),
                ("zero2", None, "hierarchical", False, False, False),
                ("zero3", "per_group", "ring", True, True, True),
                ("zero3", "per_group", "dbtree", False, True, False),
                ("zero3", "ahead", "2d_torus", True, False, True),
                ("zero3", "ahead", "psum", True, True, False))


def _sharded_vs_replicated(mesh, cases):
    """Reduced ResNet-50 on ``mesh``: each sharded step of ``cases``
    (``(key, sharding, gather, schedule, overlap, update_kernel,
    use_kernel)``) against the replicated explicit step of the same
    schedule, f32 wire; two steps, each from the replicated step's state.
    Returns, by key, the largest master and momentum differences, each
    relative to its tensor's max (absolute below 1)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import CommConfig
    from repro_torch.configs.shapes import InputShape
    from repro_torch.core import lars
    from repro_torch.core.schedule import ScheduleConfig, make_schedule
    from repro_torch.data.synthetic import make_batch_fn
    from repro_torch.models.registry import build_model
    from repro_torch.train import state as st
    from repro_torch.train.loop import make_params_reader
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import tree_flatten

    cfg = get_config("resnet50").reduced()
    model = build_model(cfg)
    sched = make_schedule(ScheduleConfig(base_lr=0.5, warmup_steps=1,
                                         total_steps=3))
    opt = lars.OptConfig(kind="lars")
    batch_fn = make_batch_fn(cfg, InputShape("t", "train", 0, 8), seed=0,
                             device=mesh.device, mesh=mesh)
    out = {}
    for key, sharding, gather, strategy, overlap, kernel, ring in cases:
        kw = dict(strategy=strategy, bucket_mb=0.02, wire_dtype="f32",
                  overlap=overlap, use_kernel=ring)
        repl = make_train_step(model, opt, sched, mesh=mesh,
                               comm=CommConfig(**kw))
        zero = make_train_step(model, opt, sched, mesh=mesh,
                               comm=CommConfig(sharding=sharding,
                                               gather=gather,
                                               update_kernel=kernel, **kw))
        plan, n = zero.bucket_plan, zero.n_shards
        assert n == mesh.size and plan.n_buckets > 10
        assert zero.sharding == sharding
        index = mesh.axis(zero.shard_axis).index
        read = make_params_reader(zero)
        s = st.init_state(model, 0, device=mesh.device)
        worst = 0.0
        for k in range(2):
            packed = lambda tree: st.local_shards(
                st.init_packed_shards(tree, plan, n), n, index)
            zs = st.TrainState(
                s.step, None if sharding == "zero3" else s.params,
                packed(s.mom), s.bn_state,
                None if sharding == "zero2" else packed(s.params))
            batch = batch_fn(k)
            s, _ = repl(s, batch)
            zs, _ = zero(zs, batch)
            assert (zs.params is None) == (sharding == "zero3")
            assert (zs.shards is None) == (sharding == "zero2")
            masters = read(zs)
            mom = read(zs._replace(shards=zs.mom))
            for got, want in ((masters, s.params), (mom, s.mom),
                              (zs.bn_state, s.bn_state)):
                for (p, a), (_, b) in zip(tree_flatten(got),
                                          tree_flatten(want)):
                    # of the tensor's max: beyond two ranks the schedules
                    # sum in another order, and an untrained step's BN
                    # scales reach 1e6
                    d = _maxdiff(a, b) / max(1.0, float(b.abs().max()))
                    assert d <= TOL, (key, k, p, d)
                    worst = max(worst, d)
        out[key] = np.float64(worst)
    return out


def zero1_step(mesh):
    """The ZeRO-1 step against the replicated explicit step, for each of
    ``ZERO1_CASES`` (``_sharded_vs_replicated``); keys
    ``{schedule}/o{overlap}u{update_kernel}``."""
    # each factor both ways, in four of the eight combinations
    return _sharded_vs_replicated(mesh, [
        (f"{s}/o{int(o)}u{int(u)}", "zero1", None, s, o, u, False)
        for s, o, u in ZERO1_CASES])


def zero23_key(sharding, gather, strategy, overlap, kernel, ring) -> str:
    return (f"{sharding}-{gather or 'at_end'}/{strategy}/o{int(overlap)}"
            f"u{int(kernel)}k{int(ring)}")


def zero23_step(mesh):
    """The zero2 and zero3 steps against the replicated explicit step,
    for each of ``ZERO23_CASES`` (``_sharded_vs_replicated``)."""
    return _sharded_vs_replicated(mesh, [(zero23_key(*c), *c)
                                         for c in ZERO23_CASES])


def ckpt_zero1(mesh):
    """Two ZeRO-1 steps (reduced ResNet-50, psum, 0.25 MB buckets: split
    tensors, the fused update), then ``checkpoint.save(mesh=...)`` into
    ``OUT_DIR/ckpt`` with the step's CommPlan, and a load back into a fresh
    template: this rank's shard and momentum rows as ``shards/{b}`` and
    ``mom/{b}``, and ``loaded_equal`` 1 if the load gave them back bit for
    bit (params and BN state too)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import CommConfig
    from repro_torch.configs.shapes import InputShape
    from repro_torch.core import lars
    from repro_torch.core.schedule import ScheduleConfig, make_schedule
    from repro_torch.data.synthetic import make_batch_fn
    from repro_torch.models.registry import build_model
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.state import init_state, sharded_state_kwargs
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import tree_flatten
    cfg = get_config("resnet50").reduced()
    model = build_model(cfg)
    step = make_train_step(model, lars.OptConfig(), make_schedule(
        ScheduleConfig(base_lr=0.5, warmup_steps=1, total_steps=3)),
        mesh=mesh, comm=CommConfig(strategy="psum", bucket_mb=0.25,
                                   sharding="zero1", update_kernel=True))
    kwargs = sharded_state_kwargs(step)
    state = init_state(model, 0, device=mesh.device, **kwargs)
    batch_fn = make_batch_fn(cfg, InputShape("t", "train", 0, 8),
                             device=mesh.device, mesh=mesh)
    for _ in range(2):
        state, _ = step(state, batch_fn(state.step))
    d = os.path.join(sys.argv[2], "ckpt")
    ckpt.save(state, d, tag=ckpt.step_tag(2), comm_plan=step.comm_plan,
              mesh=mesh)
    back = ckpt.load(init_state(model, 1, device=mesh.device, **kwargs), d,
                     mesh=mesh)
    same = back.step == 2 and all(
        torch.equal(a, b) for x, y in (
            (back.shards, state.shards), (back.mom, state.mom),
            ([v for _, v in tree_flatten(back.params)],
             [v for _, v in tree_flatten(state.params)]),
            ([v for _, v in tree_flatten(back.bn_state)],
             [v for _, v in tree_flatten(state.bn_state)]))
        for a, b in zip(x, y))
    out = {"loaded_equal": np.int64(same)}
    for field in ("shards", "mom"):
        for b, row in enumerate(getattr(state, field)):
            out[f"{field}/{b}"] = row.cpu().numpy()
    return out


def lm_zero1(mesh):
    """Reduced qwen1.5-0.5b: two ring zero1 steps over the mesh (0.1 MB
    buckets, split leaves; K3 and K2 flags on; f32 wire), each rank on its
    rows of the global batch, against two one-rank psum steps on the whole
    batch (a size-1 axis: no collective). ``masters_of_max``: the worst
    tensor's max difference over its max; ``loss_rel``: the last step's
    mean loss against the one-rank loss; ``masters_of_update``: the worst
    tensor's max difference over its largest update; ``masters_sha``: the
    gathered masters' sha256, which every rank must share."""
    import hashlib

    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import CommConfig
    from repro_torch.configs.shapes import InputShape
    from repro_torch.core import lars
    from repro_torch.core.schedule import ScheduleConfig, make_schedule
    from repro_torch.data.synthetic import make_batch_fn
    from repro_torch.launch.mesh import Axis, Mesh
    from repro_torch.models.registry import build_model
    from repro_torch.train.loop import make_params_reader
    from repro_torch.train.state import init_state, sharded_state_kwargs
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import tree_flatten
    cfg = get_config("qwen1.5-0.5b").reduced()
    model = build_model(cfg)
    sched = make_schedule(ScheduleConfig(base_lr=0.5, warmup_steps=1,
                                         total_steps=3, decay="poly2"))
    comm = dict(bucket_mb=0.1, wire_dtype="f32")
    step = make_train_step(model, lars.OptConfig(), sched, mesh=mesh,
                           comm=CommConfig(strategy="ring", sharding="zero1",
                                           use_kernel=True,
                                           update_kernel=True, **comm))
    one = Mesh((Axis("data", 1, 0, (mesh.rank,), None),), mesh.device)
    step1 = make_train_step(model, lars.OptConfig(), sched, mesh=one,
                            comm=CommConfig(strategy="psum", **comm))
    shape = InputShape("t", "train", 32, 8)
    part = make_batch_fn(cfg, shape, seed=3, device=mesh.device, mesh=mesh)
    full = make_batch_fn(cfg, shape, seed=3, device=mesh.device)
    s = init_state(model, 0, device=mesh.device, **sharded_state_kwargs(step))
    s1 = init_state(model, 0, device=mesh.device)
    p0 = [x.clone() for _, x in tree_flatten(s1.params)]
    for i in range(2):
        s, m = step(s, part(i))
        s1, m1 = step1(s1, full(i))
    got = make_params_reader(step)(s)
    pairs = list(zip(tree_flatten(got), tree_flatten(s1.params), p0))
    worst = max(float((a - b).abs().max() / b.abs().max())
                for (_, a), (_, b), _ in pairs)
    of_upd = max(float((a - b).abs().max() / (b - c).abs().max())
                 for (_, a), (_, b), c in pairs)
    h = hashlib.sha256()
    for _, x in tree_flatten(got):
        h.update(x.contiguous().numpy().tobytes())
    return {"masters_of_max": np.float64(worst),
            "masters_of_update": np.float64(of_upd),
            "loss_rel": np.float64(abs(float(m["loss"]) - float(m1["loss"]))
                                   / abs(float(m1["loss"]))),
            "masters_sha": np.frombuffer(h.digest(), np.uint8)}


#: lm_family_dp's runs over the mesh: (schedule, sharding, gather)
#: by case, as ``torch_reference.LM_DP_CASES`` names them
FAMILY_DP_CASES = {"psum": ("psum", "replicated", None),
                   "zero1": ("ring", "zero1", None),
                   "zero3": ("ring", "zero3", "per_group")}


def lm_family_dp(mesh, arch):
    """``lm_zero1`` for a family added since the dense LM's
    (``torch_reference.family_config(arch)``): for each of the family's
    cases in ``torch_reference.LM_FAMILY_DP`` (psum replicated, ring zero1
    and, for the hybrid, ring zero3 with ``gather='per_group'``; K3 and K2
    flags on; f32 wire, 0.5 MB buckets), two steps over the mesh, each rank on its rows of
    the global batch (whisper's and the VLM's frames too), against two
    one-rank psum steps on the whole batch; the hybrid and the xLSTM
    wholly in f32 (``precision.f32_compute``), as their parity steps run.
    Per case ``{case}/...``:
    ``masters_of_update``, ``loss_rel`` and ``masters_sha`` as
    ``lm_zero1`` has them (a tensor whose update is zero up to f32
    rounding held against the tree's largest update); ``labels``: this
    rank's count of labels over both steps."""
    import contextlib
    import hashlib

    import torch_reference
    from repro_torch.configs import get_config
    from repro_torch.configs.base import CommConfig
    from repro_torch.configs.shapes import InputShape
    from repro_torch.core import lars, precision
    from repro_torch.core.label_smoothing import IGNORE
    from repro_torch.core.schedule import ScheduleConfig, make_schedule
    from repro_torch.data.synthetic import make_batch_fn
    from repro_torch.launch.mesh import Axis, Mesh
    from repro_torch.models.registry import build_model
    from repro_torch.train.loop import make_params_reader
    from repro_torch.train.state import init_state, sharded_state_kwargs
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import tree_flatten
    cfg = torch_reference.family_config(get_config, arch)
    model = build_model(cfg)
    sched = make_schedule(ScheduleConfig(base_lr=0.5, warmup_steps=1,
                                         total_steps=3, decay="poly2"))
    # 0.5 MB: the wide leaves still split (whisper's dec_pos into 64
    # spans) at a fifth of 0.1 MB's buckets, which the parity tests take
    comm = dict(bucket_mb=0.5, wire_dtype="f32")
    one = Mesh((Axis("data", 1, 0, (mesh.rank,), None),), mesh.device)
    step1 = make_train_step(model, lars.OptConfig(), sched, mesh=one,
                            comm=CommConfig(strategy="psum", **comm))
    shape = InputShape("t", "train", 32, 8)
    part = make_batch_fn(cfg, shape, seed=3, device=mesh.device, mesh=mesh)
    full = make_batch_fn(cfg, shape, seed=3, device=mesh.device)
    compute = (precision.f32_compute if arch in torch_reference.LM_FAMILY_F32
               else contextlib.nullcontext)
    s1 = init_state(model, 0, device=mesh.device)
    p0 = [x.clone() for _, x in tree_flatten(s1.params)]
    losses1 = []
    for i in range(2):
        with compute():
            s1, m1 = step1(s1, full(i))
        losses1.append(float(m1["loss"]))
    out = {}
    for case in torch_reference.LM_FAMILY_DP[arch]:
        strategy, sharding, gather = FAMILY_DP_CASES[case]
        ring = strategy == "ring"
        step = make_train_step(
            model, lars.OptConfig(), sched, mesh=mesh,
            comm=CommConfig(strategy=strategy, sharding=sharding,
                            gather=gather, use_kernel=ring,
                            update_kernel=sharding != "replicated", **comm))
        s = init_state(model, 0, device=mesh.device,
                       **sharded_state_kwargs(step))
        labels = 0
        for i in range(2):
            batch = part(i)
            labels += int((batch["labels"] != IGNORE).sum())
            with compute():
                s, m = step(s, batch)
        got = make_params_reader(step)(s)
        pairs = [(float((a - b).abs().max()), float((b - c).abs().max()))
                 for (_, a), (_, b), c in zip(tree_flatten(got),
                                              tree_flatten(s1.params), p0)]
        # a tensor whose update is zero up to f32 rounding (the sLSTM's
        # b_i, whose gradient vanishes: torch_reference.F32_ZERO) against
        # the tree's largest update
        top = max(u for _, u in pairs)
        of_upd = max(d / (u if u > torch_reference.F32_ZERO * top else top)
                     for d, u in pairs)
        h = hashlib.sha256()
        for _, x in tree_flatten(got):
            h.update(x.contiguous().numpy().tobytes())
        out.update({f"{case}/masters_of_update": np.float64(of_upd),
                    f"{case}/loss_rel": np.float64(
                        abs(float(m["loss"]) - losses1[-1])
                        / abs(losses1[-1])),
                    f"{case}/masters_sha": np.frombuffer(h.digest(),
                                                         np.uint8),
                    f"{case}/labels": np.int64(labels)})
    return out


#: ``lm_xla_dp``'s CLI run: a frames family (its rows and frames split
#: over the data ranks) through ``--comm xla`` at model 1
XLA_DP_CLI = ("--arch", "whisper-base", "--reduced", "--comm", "xla",
              "--device", "cpu", "--steps", "2", "--batch", "4", "--seq",
              "16")


def lm_xla_dp(mesh):
    """``comm='xla'`` over the ranks at model 1 (``make_local_mesh()``: a
    (world, 1) mesh, GSPMD's pure data parallelism): for the dense decoder
    and each family of ``torch_reference.LM_FAMILY_DP``
    (``xla_dp_archs``), two steps, each rank on its rows of the global
    batch (the frames too), against two one-rank ``comm='xla'`` steps on
    the whole batch; the hybrid and the xLSTM wholly in f32, the others
    differentiating the bf16 compute copy. Per arch ``{arch}/...`` as
    ``lm_family_dp`` has them (``masters_of_update``, ``loss_rel``,
    ``masters_sha``, ``labels``); ``cli``: ``XLA_DP_CLI`` reached
    run_stop."""
    import contextlib
    import hashlib
    import io

    import torch_reference
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.core import lars, precision
    from repro_torch.core.label_smoothing import IGNORE
    from repro_torch.core.schedule import ScheduleConfig, make_schedule
    from repro_torch.data.synthetic import make_batch_fn
    from repro_torch.launch import train as cli
    from repro_torch.models.registry import build_model
    from repro_torch.train.state import init_state
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import tree_flatten
    sched = make_schedule(ScheduleConfig(base_lr=0.5, warmup_steps=1,
                                         total_steps=3, decay="poly2"))
    shape = InputShape("t", "train", 32, 8)
    out = {}
    for arch in xla_dp_archs():
        cfg = torch_reference.family_config(get_config, arch)
        model = build_model(cfg)
        f32 = arch in torch_reference.LM_FAMILY_F32
        compute = precision.f32_compute if f32 else contextlib.nullcontext
        steps = [make_train_step(model, lars.OptConfig(), sched, mesh=m,
                                 comm="xla",
                                 comm_dtype="f32" if f32 else "bf16")
                 for m in (None, mesh)]
        batches = [make_batch_fn(cfg, shape, seed=3, device=mesh.device,
                                 mesh=m, axes=("data",))
                   for m in (None, mesh)]
        s1, s = (init_state(model, 0, device=mesh.device) for _ in range(2))
        p0 = [x.clone() for _, x in tree_flatten(s1.params)]
        labels = 0
        for i in range(2):
            batch = batches[1](i)
            labels += int((batch["labels"] != IGNORE).sum())
            with compute():
                s1, m1 = steps[0](s1, batches[0](i))
                s, m = steps[1](s, batch)
        pairs = [(float((a - b).abs().max()), float((b - c).abs().max()))
                 for (_, a), (_, b), c in zip(tree_flatten(s.params),
                                              tree_flatten(s1.params), p0)]
        top = max(u for _, u in pairs)
        of_upd = max(d / (u if u > torch_reference.F32_ZERO * top else top)
                     for d, u in pairs)
        h = hashlib.sha256()
        for _, x in tree_flatten(s.params):
            h.update(x.contiguous().numpy().tobytes())
        out.update({f"{arch}/masters_of_update": np.float64(of_upd),
                    f"{arch}/loss_rel": np.float64(
                        abs(float(m["loss"]) - float(m1["loss"]))
                        / abs(float(m1["loss"]))),
                    f"{arch}/masters_sha": np.frombuffer(h.digest(),
                                                         np.uint8),
                    f"{arch}/labels": np.int64(labels)})
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        history = cli.main(list(XLA_DP_CLI))
    steps = [h["loss"] for h in history if "loss" in h]
    out["cli"] = np.bool_(len(steps) == 2 and np.isfinite(steps).all()
                          and "run_stop" in buf.getvalue())
    return out


def xla_dp_archs():
    """``lm_xla_dp``'s archs: the dense decoder and the families of the
    explicit data-parallel ladder's tests."""
    import torch_reference
    return ("qwen1.5-0.5b",) + tuple(torch_reference.LM_FAMILY_DP)


#: the within-port variants of ``lm_tp``: the reduced qwen1.5-0.5b as it
#: is, and with ``qk_norm`` and a 16-token sliding window set
TP_VARIANTS = {"base": {}, "qkw": {"qk_norm": True, "sliding_window": 16}}
#: ``lm_tp``'s CLI run (ROADMAP §1 item 6.2 under ``torchrun``)
TP_CLI = ("--arch", "qwen1.5-0.5b", "--reduced", "--model-parallel", "2",
          "--comm", "xla", "--device", "cpu", "--steps", "2", "--batch",
          "4", "--seq", "32", "--eval-every", "2")


def _rows(x, axis, dim=0):
    """Every data rank's rows of ``x`` along ``dim``, in rank order."""
    import torch
    import torch.distributed as dist
    if axis.size == 1:
        return x.clone()             # a copy, as the gather's is
    parts = [torch.empty_like(x) for _ in range(axis.size)]
    dist.all_gather(parts, x.contiguous(), group=axis.group)
    return torch.cat(parts, dim=dim)


def _rel(got, want) -> float:
    """Largest difference over the reference's largest magnitude."""
    got = got.detach().float().numpy() if hasattr(got, "detach") else got
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _tp_run(model, params, toks, tpm, cache_len, new, frames=None,
            train_len=None):
    """The port over ``tpm`` (a rank's shards ``params``, its data row
    of ``toks`` and of whisper's or the VLM's stub ``frames``): the
    forward over all of ``toks`` (its first ``train_len``, given), the
    prefill of all but the last token,
    one decode step of the last and ``generate``'s ``new`` greedy tokens,
    each gathered over the mesh (the cache over ``model`` by its spec,
    then every output over ``data``; the caches as ``{path: leaf}``), as
    numpy."""
    import torch
    from repro_torch import weights
    from repro_torch.models import transformer
    from repro_torch.models.common import model_axis
    from repro_torch.serve.decode import generate, prefix_len
    from repro_torch.tree import tree_flatten
    d = tpm.axis("data")
    n = toks.shape[0] // d.size
    mine = torch.from_numpy(toks[d.index * n:(d.index + 1) * n])
    extra = ({} if frames is None else
             {"frames": torch.from_numpy(frames[d.index * n:
                                                (d.index + 1) * n])})
    P = toks.shape[1] - 1
    m = model_axis(tpm)
    with torch.no_grad():
        (logits, _), _ = model.forward_train(
            params, {"tokens": mine[:, :train_len], **extra}, mesh=tpm)
        last, cache = model.forward_prefill(
            params, {"tokens": mine[:, :P], **extra}, cache_len, tpm)
        pd = transformer.cache_pd(model.cfg, toks.shape[0], cache_len,
                                  1 if m is None else m.size)
        rows_dim = {p: list(x.spec).index("data")
                    for p, x in tree_flatten(pd)}
        whole = lambda c: {p: _rows(v, d, rows_dim[p]) for p, v in
                           tree_flatten(weights.gather_tree(c, pd, tpm))}
        out = {"train_logits": _rows(logits, d), "prefill_logits": _rows(
            last, d), "cache": whole(cache)}
        dl, cache = model.forward_decode(params, cache, mine[:, P:],
                                         P + prefix_len(model.cfg), tpm)
        out.update(decode_logits=_rows(dl, d), decode_cache=whole(cache))
        gen = generate(model, params, {"tokens": mine[:, :P], **extra},
                       max_new=new, cache_len=cache_len, mesh=tpm)
    out["generate"] = _rows(gen, d)
    out["mine"] = (mine, gen, extra.get("frames"))
    return out


def _tp_step_errors(base, r, tpm, f32: bool, kind: str = "lars",
                    zero=()):
    """The port's ``comm='xla'`` step (optimizer ``kind``) over ``tpm``
    from each of the reference's step inputs ``r['s{k}']['in']`` (sharded
    by spec) on the rows of the rank's data index of its batch, against
    its output:
    (the loss's relative difference, the masters' worst difference over
    their tensor's largest update, the momentum's over its tensor's
    largest element), each the worst over the steps. The leaves at the
    paths ``zero`` (whose reference gradient vanishes up to f32 rounding:
    their update is their weight decay and noise) are left out of the two
    and reported after them, the same two figures over those leaves."""
    import contextlib
    import types

    import torch
    from repro_torch import weights
    from repro_torch.core import lars, precision
    from repro_torch.core.schedule import ScheduleConfig, make_schedule
    from repro_torch.models.registry import build_model
    from repro_torch.train.step import make_train_step
    from repro_torch.train.state import TrainState
    from repro_torch.tree import tree_flatten
    import torch_reference as R
    model = build_model(base)
    step = make_train_step(model, lars.OptConfig(kind=kind),
                           make_schedule(ScheduleConfig(**R.LR)), mesh=tpm,
                           comm="xla", comm_dtype="f32" if f32 else "bf16")
    d = tpm.axis("data")
    worst = [0.0] * (5 if zero else 3)
    for k in range(R.LM_TRAIN_STEPS):
        rk = r[f"s{k}"]
        full = weights.lm_state_from_jax(types.SimpleNamespace(**rk["in"]),
                                         base, "cpu")
        state = TrainState(full.step, *(
            weights.shard_tree(t, model.param_pd, tpm)
            for t in (full.params, full.mom)))
        n = R.LM_TRAIN_BATCH // d.size
        batch = {name: torch.from_numpy(v[d.index * n:(d.index + 1) * n])
                 for name, v in rk["batch"].items()}
        with precision.f32_compute() if f32 else contextlib.nullcontext():
            state, metrics = step(state, batch)
        got = [dict(tree_flatten(weights.to_numpy(weights.gather_tree(
            t, model.param_pd, tpm)))) for t in (state.params, state.mom)]
        p_in = dict(tree_flatten(rk["in"]["params"]))
        want = [dict(tree_flatten(rk["out"][x])) for x in ("params", "mom")]
        loss = float(rk["metrics"]["loss"])
        worst[0] = max(worst[0], abs(float(metrics["loss"]) - loss)
                       / abs(loss))
        for j, paths in ((1, [p for p in want[0] if p not in zero]),
                         (3, list(zero))):
            if j >= len(worst):
                continue
            worst[j] = max([worst[j]] + [
                np.abs(got[0][p] - want[0][p]).max()
                / max(np.abs(want[0][p] - p_in[p]).max(), 1e-30)
                for p in paths])
            worst[j + 1] = max([worst[j + 1]] + [
                np.abs(got[1][p] - want[1][p]).max()
                / max(np.abs(want[1][p]).max(), 1e-30) for p in paths])
    return worst


def _sha(tensors) -> np.ndarray:
    import hashlib
    h = hashlib.sha256()
    for x in tensors:
        h.update(x.detach().contiguous().numpy().tobytes())
    return np.frombuffer(h.digest(), np.uint8)


def _tp_held(out, tpm, prefix, model, params, r, toks, f32, frames=None,
             train_len=None):
    """``_tp_run`` over ``tpm`` against the reference's ``_lm_run``
    outputs ``r``: each output's worst difference over the reference's max
    as ``{prefix}/{name}`` (the caches over every leaf), and
    ``{prefix}/ties`` (``check_greedy_tokens`` on the rank's rows; bf16 at
    the serving margin 3e-2). ``frames``: whisper's and the VLM's;
    ``train_len``: ``_tp_run``'s."""
    import contextlib

    import torch
    import torch_reference as R
    from repro_torch.core import precision
    from repro_torch.tree import tree_flatten
    P, C, NEW = R.LM_PROMPT, R.tp_case_cache(model.cfg), R.LM_NEW
    d = tpm.axis("data")
    compute = precision.f32_compute if f32 else contextlib.nullcontext
    with compute():
        got = _tp_run(model, params, toks, tpm, C, NEW, frames, train_len)
    for name in ("train_logits", "prefill_logits", "decode_logits"):
        out[f"{prefix}/{name}"] = _rel(got[name], r[name])
    for name in ("cache", "decode_cache"):
        out[f"{prefix}/{name}"] = max(_rel(got[name][k], v)
                                      for k, v in tree_flatten(r[name]))
    mine, gen, my_frames = got["mine"]
    n = toks.shape[0] // d.size
    with compute(), torch.no_grad():
        ties = R.check_greedy_tokens(
            model, params, mine[:, :P],
            r["generate"][d.index * n:(d.index + 1) * n],
            gen.numpy(), C, rel_margin=None if f32 else 3e-2, mesh=tpm,
            frames=my_frames)
    out[f"{prefix}/ties"] = np.int64(ties.sum())


def _tp_self(cfg, tpm, prefix, out, seed=5, train_len=None,
             one=contextlib.nullcontext):
    """``cfg`` over ``tpm`` against the port with no mesh (each of its
    runs inside ``one()``: the MoE layer's chunked plain function, whose
    answer is the mesh's; ``train_len``: ``_tp_run``'s), wholly in f32
    (``precision.f32_compute``), from ``pinit``'s params at ``seed``:
    ``{prefix}/logits`` (the forward, prefill and decode, over the logit
    max; whisper's and the VLM's with their stub frames), ``{prefix}/
    masters`` and ``mom`` (two LARS steps against the no-mesh step on the
    whole batch, over the largest update and the largest momentum
    element), ``{prefix}/sha_rep`` and ``sha_all`` (this rank's replicated
    masters and momentum, and all its shards)."""
    import torch
    import torch_reference as R
    from repro_torch import weights
    from repro_torch.core import lars, pinit, precision
    from repro_torch.core.schedule import ScheduleConfig, make_schedule
    from repro_torch.data.synthetic import token_batch
    from repro_torch.models.common import local_slice, model_axis
    from repro_torch.models.registry import build_model
    from repro_torch.serve.decode import prefix_len
    from repro_torch.train.state import init_state, sharded_state_kwargs
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import tree_flatten
    P, C, NEW = R.LM_PROMPT, R.tp_case_cache(cfg), R.LM_NEW
    d, tp = tpm.axis("data"), model_axis(tpm)
    sched = make_schedule(ScheduleConfig(**R.LR))
    model = build_model(cfg)
    toks = R.lm_tokens(cfg)
    frames = R.lm_frames(cfg) if cfg.encoder is not None else None
    extra = {} if frames is None else {"frames": torch.from_numpy(frames)}
    full = pinit.materialize(model.param_pd, seed, "cpu")
    with precision.f32_compute():
        got = _tp_run(model, weights.shard_tree(full, model.param_pd, tpm),
                      toks, tpm, C, NEW, frames, train_len)
        with torch.no_grad(), one():
            t = torch.from_numpy(toks)
            (lg, _), _ = model.forward_train(
                full, {"tokens": t[:, :train_len], **extra})
            last, cache = model.forward_prefill(
                full, {"tokens": t[:, :P], **extra}, C)
            dl, _ = model.forward_decode(full, cache, t[:, P:],
                                         P + prefix_len(cfg))
    out[f"{prefix}/logits"] = max(
        _rel(got["train_logits"], lg.numpy()),
        _rel(got["prefill_logits"], last.numpy()),
        _rel(got["decode_logits"], dl.numpy()))
    step1 = make_train_step(model, lars.OptConfig(kind="lars"), sched,
                            comm="xla", comm_dtype="f32")
    two = make_train_step(model, lars.OptConfig(kind="lars"), sched,
                          mesh=tpm, comm="xla", comm_dtype="f32")
    s1 = init_state(model, seed, device="cpu")
    s2 = init_state(model, seed, device="cpu", **sharded_state_kwargs(two))
    p0 = dict(tree_flatten(s1.params))
    n = R.LM_TRAIN_BATCH // d.size
    for k in range(R.LM_TRAIN_STEPS):
        batch = token_batch(cfg, batch=R.LM_TRAIN_BATCH, seq=R.LM_TRAIN_SEQ,
                            step=k, kind="lcg", device="cpu")
        with precision.f32_compute():
            with one():
                s1, _ = step1(s1, batch)
            s2, _ = two(s2, {x: v[d.index * n:(d.index + 1) * n]
                             for x, v in batch.items()})
    got, got_m = (dict(tree_flatten(weights.gather_tree(
        t, model.param_pd, tpm))) for t in (s2.params, s2.mom))
    want, want_m = dict(tree_flatten(s1.params)), dict(tree_flatten(s1.mom))
    upd = max(float((want[p] - p0[p]).abs().max()) for p in want)
    out[f"{prefix}/masters"] = max(
        float((got[p] - want[p]).abs().max()) for p in want) / upd
    out[f"{prefix}/mom"] = max(
        float((got_m[p] - want_m[p]).abs().max()) for p in want_m) \
        / max(float(m.abs().max()) for m in want_m.values())
    pds = dict(tree_flatten(model.param_pd))
    shards = tree_flatten(s2.params) + tree_flatten(s2.mom)
    out[f"{prefix}/sha_rep"] = _sha(
        x for p, x in shards if local_slice(pds[p], tp)[0] is None)
    out[f"{prefix}/sha_all"] = _sha(x for _, x in shards)


def lm_tp(mesh, ref_path):
    """The model axis (ROADMAP §1 item 6.2) on four ranks as a (data 2,
    model 2) mesh (``launch.mesh.make_local_mesh(2)``), against the
    reference's GSPMD run on its (2, 2) mesh (``torch_reference.py
    tp_cases``, read from ``ref_path``) and against the port at model 1.
    Per arch of ``torch_reference.TP_ARCHS`` and dtype (``f0`` bf16,
    ``f1`` wholly in f32, ``precision.f32_compute``), as
    ``{arch}/f{f32}/...``: ``_tp_run``'s outputs' worst differences over
    the reference's max (``prefill``, ``train``, ``decode``, ``cache``,
    ``decode_cache``), ``ties`` (``check_greedy_tokens`` on the rank's
    rows; bf16 at the serving margin 3e-2) and ``step`` (loss, masters,
    momentum: ``_tp_step_errors``), ``{arch}/sgdm/step`` the same for
    the f32 sgdm steps; ``flash/...`` the same for the flash path. Within
    the port, in f32 (``TP_VARIANTS``): ``self/{v}/logits`` (the forward,
    prefill and decode at model 2 against the full tree without a mesh,
    over the logit max), ``self/{v}/masters`` and ``mom`` (two steps
    against the no-mesh step on the whole batch, over the largest update
    and the largest momentum element), ``self/{v}/sha_rep`` and
    ``sha_all`` (this rank's replicated masters and all its shards);
    ``pinit`` (its shards equal the whole leaves' slices, f32 and bf16,
    for both archs); ``cli`` (``launch.train.main`` reached run_stop)."""
    import contextlib
    import dataclasses
    import io

    import torch
    import torch_reference as R
    from repro_torch import weights
    from repro_torch.configs import get_config
    from repro_torch.core import pinit
    from repro_torch.launch import train as cli
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.registry import build_model
    from repro_torch.tree import tree_flatten

    tpm = make_local_mesh(2, device="cpu")
    ref = R.load(ref_path)
    out = {}

    def held(*args):
        _tp_held(out, tpm, *args)

    for arch in R.TP_ARCHS:
        base = get_config(arch).reduced()
        model = build_model(base)
        toks = R.lm_tokens(base)
        params = weights.lm_params_from_jax(ref[arch]["params"], base, "cpu",
                                            mesh=tpm)
        for f32 in (0, 1):
            r = ref[arch][f"f{f32}"]
            held(f"{arch}/f{f32}", model, params, r["run"], toks, f32)
            out[f"{arch}/f{f32}/step"] = np.array(
                _tp_step_errors(base, r["train"], tpm, bool(f32)))
        out[f"{arch}/sgdm/step"] = np.array(_tp_step_errors(
            base, ref[arch]["sgdm"]["train"], tpm, True, "sgdm"))
    base = dataclasses.replace(get_config(R.TP_ARCHS[0]).reduced(),
                               flash_attention=True)
    held("flash", build_model(base), weights.lm_params_from_jax(
        ref[R.TP_ARCHS[0]]["params"], base, "cpu", mesh=tpm),
        ref["flash"]["run"], R.lm_tokens(base), False)

    # within the port, in f32: model 2 against model 1
    for name, kw in TP_VARIANTS.items():
        cfg = dataclasses.replace(get_config(R.TP_ARCHS[0]).reduced(), **kw)
        _tp_self(cfg, tpm, f"self/{name}", out)

    same = True
    for arch in R.TP_ARCHS:
        pd = build_model(get_config(arch).reduced()).param_pd
        for dt in (None, torch.bfloat16):
            mine = pinit.materialize(pd, 7, "cpu", dtype=dt, mesh=tpm)
            cut = weights.shard_tree(pinit.materialize(pd, 7, "cpu",
                                                       dtype=dt), pd, tpm)
            same &= all(a.dtype == b.dtype and torch.equal(a, b)
                        for (_, a), (_, b) in zip(tree_flatten(mine),
                                                  tree_flatten(cut)))
    out["pinit"] = np.bool_(same)

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        history = cli.main(list(TP_CLI))
    steps = [h["loss"] for h in history if "loss" in h]
    out["cli"] = np.bool_(len(steps) == 2 and np.isfinite(steps).all()
                          and any("eval_loss" in h for h in history)
                          and "run_stop" in buf.getvalue())
    tpm.destroy()
    return out


#: ``lm_tp_recurrent``'s CLI run: the hybrid at --model-parallel 2 with
#: the guard on (ROADMAP §1 item 6.2b under ``torchrun``)
TP_RECURRENT_CLI = ("--arch", "zamba2-7b", "--reduced", "--model-parallel",
                    "2", "--comm", "xla", "--device", "cpu", "--steps", "2",
                    "--batch", "4", "--seq", "32", "--guard")


def _tp_from_ref(tree, base, tpm):
    """A reference tree at the params' paths -> this rank's shards."""
    from repro_torch import weights
    return weights.lm_params_from_jax(tree, base, "cpu", mesh=tpm)


def _tp_one_step(base, rk, tpm, kind, guard_in=None):
    """The port's f32 ``comm='xla'`` step (optimizer ``kind``; guarded
    where ``guard_in`` is given) over ``tpm`` from the reference's step
    input ``rk['in']`` on the rank's rows of its batch. Returns (the input
    state, the output state, its metrics)."""
    import torch
    import torch_reference as R
    from repro_torch.core import lars, precision
    from repro_torch.core.schedule import ScheduleConfig, make_schedule
    from repro_torch.models.registry import build_model
    from repro_torch.train.state import TrainState
    from repro_torch.train.step import make_train_step
    step = make_train_step(build_model(base), lars.OptConfig(kind=kind),
                           make_schedule(ScheduleConfig(**R.LR)), mesh=tpm,
                           comm="xla", comm_dtype="f32",
                           guard=guard_in is not None)
    mom = rk["in"]["mom"]
    mom = ({"m": _tp_from_ref(mom["m"], base, tpm),
            "v": _tp_from_ref(mom["v"], base, tpm),
            "count": int(mom["count"])} if kind == "lamb"
           else _tp_from_ref(mom, base, tpm))
    state = TrainState(int(rk["in"]["step"]),
                       _tp_from_ref(rk["in"]["params"], base, tpm), mom)
    d = tpm.axis("data")
    n = R.LM_TRAIN_BATCH // d.size
    batch = {name: torch.from_numpy(v[d.index * n:(d.index + 1) * n])
             for name, v in rk["batch"].items()}
    with precision.f32_compute():
        out = step(state, batch, *([guard_in] if guard_in else []))
    return (state, *out)


def _tp_whole(tree, base, tpm):
    """A rank's shard tree gathered over ``tpm``'s model axis, as a flat
    ``{path: numpy}``."""
    from repro_torch import weights
    from repro_torch.models.registry import build_model
    from repro_torch.tree import tree_flatten
    return dict(tree_flatten(weights.to_numpy(weights.gather_tree(
        tree, build_model(base).param_pd, tpm))))


def _of_update(got, want, before):
    """The worst tensor's difference over its largest update."""
    return max(np.abs(got[p] - want[p]).max()
               / max(np.abs(want[p] - before[p]).max(), 1e-30) for p in want)


def _of_max(got, want):
    """The worst tensor's difference over its largest element."""
    return max(np.abs(got[p] - want[p]).max()
               / max(np.abs(want[p]).max(), 1e-30) for p in want)


def lm_tp_recurrent(mesh, ref_path):
    """The model axis (ROADMAP §1 item 6.2b) for the hybrid and the xLSTM
    on four ranks as a (data 2, model 2) mesh, against the reference's
    GSPMD run on its (2, 2) mesh (``torch_reference.py
    tp_recurrent_cases``, read from ``ref_path``), wholly in f32 (the
    recurrent families' gate), and against the port at model 1. Per arch
    of ``torch_reference.TP_RECURRENT_ARCHS`` (at ``tp_config``):
    ``_tp_held``'s ``{arch}/...`` (logits, caches, ties), ``{arch}/step``
    and ``{arch}/sgdm/step`` (``_tp_step_errors``: two LARS and two sgdm
    steps; the xLSTM's sLSTM input-gate biases, whose gradient vanishes,
    apart), ``self/{arch}/...`` (``_tp_self``). The hybrid's LAMB step:
    ``{arch}/lamb`` (loss, masters of the update, m and v over their
    largest); its guarded step: ``{arch}/guard/ok`` (loss, masters,
    momentum, gnorm relative, |skipped - the reference's|) and
    ``{arch}/guard/bad`` (skipped, nonfinite > 0, the state returned
    untouched: 1 each where so); ``cli``: TP_RECURRENT_CLI reached run_stop
    on every step."""
    import contextlib
    import io

    import torch
    import torch_reference as R
    from repro_torch import weights
    from repro_torch.configs import get_config
    from repro_torch.core import pinit
    from repro_torch.launch import train as cli
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.registry import build_model
    from repro_torch.train import guard as guard_lib
    from repro_torch.tree import tree_flatten

    tpm = make_local_mesh(2, device="cpu")
    ref = R.load(ref_path)
    out = {}
    for arch in R.TP_RECURRENT_ARCHS:
        base = R.tp_config(get_config, arch)
        model = build_model(base)
        r = ref[arch]
        _tp_held(out, tpm, arch, model, _tp_from_ref(r["params"], base, tpm),
                 r["run"], R.lm_tokens(base), 1)
        zero = R.zero_grad_leaves(base)
        out[f"{arch}/step"] = np.array(_tp_step_errors(
            base, r["train"], tpm, True, zero=zero))
        out[f"{arch}/sgdm/step"] = np.array(_tp_step_errors(
            base, r["sgdm"], tpm, True, "sgdm", zero=zero))
        _tp_self(base, tpm, f"self/{arch}", out)
        if arch != R.HYBRID_ARCH:
            continue
        rk = r["lamb"]
        _, state, metrics = _tp_one_step(base, rk, tpm, "lamb")
        flat = lambda t: dict(tree_flatten(t))  # noqa: E731
        before = flat(rk["in"]["params"])
        out[f"{arch}/lamb"] = np.array([
            abs(float(metrics["loss"]) - float(rk["metrics"]["loss"]))
            / abs(float(rk["metrics"]["loss"])),
            _of_update(_tp_whole(state.params, base, tpm),
                       flat(rk["out"]["params"]), before),
            _of_max(_tp_whole(state.mom["m"], base, tpm),
                    flat(rk["out"]["mom"]["m"])),
            _of_max(_tp_whole(state.mom["v"], base, tpm),
                    flat(rk["out"]["mom"]["v"]))])
        for name, scale in (("ok", 1.0), ("bad", np.inf)):
            rk = r["guard"][name]
            state_in, state, m = _tp_one_step(
                base, rk, tpm, "lars", dict(guard_lib.neutral_inputs(),
                                            loss_scale=np.float32(scale)))
            want = rk["metrics"]
            if name == "ok":
                out[f"{arch}/guard/ok"] = np.array([
                    abs(float(m["loss"]) - float(want["loss"]))
                    / abs(float(want["loss"])),
                    _of_update(_tp_whole(state.params, base, tpm),
                               flat(rk["out"]["params"]),
                               flat(rk["in"]["params"])),
                    _of_max(_tp_whole(state.mom, base, tpm),
                            flat(rk["out"]["mom"])),
                    abs(float(m["gnorm"]) - float(want["gnorm"]))
                    / float(want["gnorm"]),
                    abs(float(m["skipped"]) - float(want["skipped"]))])
            else:
                out[f"{arch}/guard/bad"] = np.array([
                    float(m["skipped"]) == float(want["skipped"]) == 1.0,
                    float(m["nonfinite"]) > 0 and float(
                        want["nonfinite"]) > 0,
                    state is state_in
                    and int(state.step) == int(rk["out"]["step"])])
    same = True
    for arch in R.TP_RECURRENT_ARCHS:
        pd = build_model(R.tp_config(get_config, arch)).param_pd
        for dt in (None, torch.bfloat16):
            mine = pinit.materialize(pd, 7, "cpu", dtype=dt, mesh=tpm)
            cut = weights.shard_tree(pinit.materialize(pd, 7, "cpu",
                                                       dtype=dt), pd, tpm)
            same &= all(a.dtype == b.dtype and torch.equal(a, b)
                        for (_, a), (_, b) in zip(tree_flatten(mine),
                                                  tree_flatten(cut)))
    out["pinit"] = np.bool_(same)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        history = cli.main(list(TP_RECURRENT_CLI))
    steps = [h["loss"] for h in history if "loss" in h]
    out["cli"] = np.bool_(len(steps) == 2 and np.isfinite(steps).all()
                          and "run_stop" in buf.getvalue())
    tpm.destroy()
    return out


#: ``xla_conv``'s CLI run: ResNet-50 under --comm xla over the ranks
XLA_CONV_CLI = ("--arch", "resnet50", "--reduced", "--comm", "xla",
                "--device", "cpu", "--steps", "2", "--batch", "8")


def _relnorm(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def xla_conv(mesh, ref_path):
    """ResNet-50 under ``comm='xla'`` over the ranks at model 1 (ROADMAP
    §1 item 6.2b), each rank on its rows, against the reference's GSPMD
    run on its (2, 1) mesh (``torch_reference.py xla_conv_cases``, read
    from ``ref_path``), for each ``sync_bn`` form (``s{sync}/...``):
    ``fwd`` (the logits' largest difference, gathered over the ranks; the
    new BN statistics' worst over their tensor's max; the gradients'
    (meaned over the ranks) worst and median relative L2 error per
    tensor), ``s{k}`` for each reference step from its own input state
    (the loss's relative difference; the update's and the momentum's
    worst and median relative L2 per tensor; the masters' worst; the BN
    state's worst over its max), ``one`` (step 0 at one rank on the whole
    batch against the two ranks: the same figures), ``sha`` (this rank's
    masters, momentum and BN state after the last step). ``cli``:
    XLA_CONV_CLI reached run_stop."""
    import contextlib
    import dataclasses
    import io
    import types

    import torch
    import torch_reference as R
    from repro_torch import weights
    from repro_torch.comm import primitives as prim
    from repro_torch.configs import get_config
    from repro_torch.core import lars
    from repro_torch.core.schedule import ScheduleConfig, make_schedule
    from repro_torch.launch import train as cli
    from repro_torch.models.registry import build_model
    from repro_torch.core.label_smoothing import smoothed_xent
    from repro_torch.core.precision import cast_to_compute
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import tree_flatten, tree_map, tree_unflatten

    ref = R.load(ref_path)
    d = mesh.axis("data")
    n = R.BATCH // d.size
    mine = lambda v: torch.from_numpy(np.ascontiguousarray(  # noqa: E731
        v[d.index * n:(d.index + 1) * n]))
    flat = lambda t: dict(tree_flatten(weights.to_numpy(t)))  # noqa: E731
    sched = make_schedule(ScheduleConfig(**R.LR))
    base = get_config("resnet50").reduced()
    out = {}

    def step_errors(state_in, state, metrics, want):
        p_in = flat(state_in.params)
        got_p, got_m, got_b = (flat(t) for t in (state.params, state.mom,
                                                  state.bn_state))
        want_p, want_m, want_b = (dict(tree_flatten(want["out"][k]))
                                  for k in ("params", "mom", "bn_state"))
        upd = [_relnorm(got_p[p] - p_in[p], want_p[p] - p_in[p])
               for p in want_p]
        mom = [_relnorm(got_m[p], want_m[p]) for p in want_m]
        return np.array([
            abs(float(metrics["loss"]) - float(want["metrics"]["loss"]))
            / abs(float(want["metrics"]["loss"])),
            max(upd), np.median(upd), max(mom), np.median(mom),
            max(_relnorm(got_p[p], want_p[p]) for p in want_p),
            _of_max(got_b, want_b)])

    for sync in (0, 1):
        cfg = dataclasses.replace(base, sync_bn=bool(sync))
        model = build_model(cfg)
        r = ref[f"s{sync}"]
        pre = f"s{sync}"
        # the forward over the mesh and the gradients, meaned over the ranks
        params = weights.params_from_jax(ref["params"], cfg, "cpu")
        bn = weights.bn_state_from_jax(ref["bn"], cfg, "cpu")
        b0 = r["s0"]["batch"]
        p_in = tree_map(lambda x: x.detach().requires_grad_(),
                        cast_to_compute(params))
        leaves = tree_flatten(p_in)
        (logits, _), new_bn = model.forward_train(
            p_in, {"images": mine(b0["images"])}, bn, mesh)
        loss, _ = smoothed_xent(logits, mine(b0["labels"]))
        grads = torch.autograd.grad(loss, [x for _, x in leaves])
        grads = prim.pmean_tree(tree_unflatten(
            [p for p, _ in leaves], [g.float() for g in grads]), (d,))
        want = r["fwd"]
        want_g = dict(tree_flatten(want["grads"]))
        errs = [_relnorm(g, want_g[p]) for p, g in flat(grads).items()]
        out[f"{pre}/fwd"] = np.array([
            float(np.abs(_rows(logits.detach(), d).numpy()
                         - want["logits"]).max()),
            _of_max(flat(new_bn), dict(tree_flatten(want["new_bn"]))),
            max(errs), np.median(errs)])
        # the steps, each from the reference's input state
        step = make_train_step(model, lars.OptConfig(), sched, mesh=mesh,
                               comm="xla")
        for k in range(R.XLA_CONV_STEPS):
            rk = r[f"s{k}"]
            state_in = weights.state_from_jax(types.SimpleNamespace(
                **rk["in"], shards=None), cfg, "cpu")
            state, metrics = step(state_in, {x: mine(v) for x, v in
                                             rk["batch"].items()})
            out[f"{pre}/s{k}"] = step_errors(state_in, state, metrics, rk)
        out[f"{pre}/sha"] = _sha([x for t in (state.params, state.mom,
                                              state.bn_state)
                                  for _, x in tree_flatten(t)])
        # one rank on the whole batch against the two ranks
        rk = r["s0"]
        state_in = weights.state_from_jax(types.SimpleNamespace(
            **rk["in"], shards=None), cfg, "cpu")
        two, m2 = step(state_in, {x: mine(v) for x, v in rk["batch"].items()})
        one, m1 = make_train_step(model, lars.OptConfig(), sched,
                                  comm="xla")(
            state_in, {x: torch.from_numpy(v) for x, v in
                       rk["batch"].items()})
        as_ref = {"out": {"params": flat(one.params), "mom": flat(one.mom),
                          "bn_state": flat(one.bn_state)},
                  "metrics": {"loss": m1["loss"]}}
        out[f"{pre}/one"] = step_errors(state_in, two, m2, as_ref)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        history = cli.main(list(XLA_CONV_CLI))
    steps = [h["loss"] for h in history if "loss" in h]
    out["cli"] = np.bool_(len(steps) == 2 and np.isfinite(steps).all()
                          and "run_stop" in buf.getvalue())
    return out


#: ``lm_tp_frames``'s CLI run: whisper over the model axis (ROADMAP §1
#: item 6.2c under ``torchrun``)
TP_FRAMES_CLI = ("--arch", "whisper-base", "--reduced", "--model-parallel",
                 "2", "--comm", "xla", "--device", "cpu", "--steps", "2",
                 "--batch", "4", "--seq", "16")


def _cli_ok(argv, steps: int) -> bool:
    """``launch.train.main(argv)`` in this rank's process: ``steps``
    finite losses logged and run_stop."""
    import contextlib
    import io

    from repro_torch.launch import train as cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        history = cli.main(list(argv))
    losses = [h["loss"] for h in history if "loss" in h]
    return bool(len(losses) == steps and np.isfinite(losses).all()
                and "run_stop" in buf.getvalue())


def lm_tp_frames(mesh, ref_path):
    """The model axis (ROADMAP §1 item 6.2c) on four ranks, against the
    reference's GSPMD runs (``torch_reference.py tp_frames_cases``, read
    from ``ref_path``): whisper and the VLM at (data 2, model 2) in bf16
    and f32 (``{arch}/f{f32}/...``), and the heads the axis does not
    divide in f32 (``torch_reference.TP_HEAD_CASES``: MQA at (2, 2), two
    heads over model 4 at (1, 4); ``{case}/f1/...``): ``_tp_held``'s
    outputs and ties, ``step`` (``_tp_step_errors``: loss, masters,
    momentum). Within the port, in f32, at (2, 2): ``self/{name}/...``
    (``_tp_self``: model 2 against the port with no mesh); ``pinit``: its
    shards of whisper's and the VLM's trees equal the whole leaves'
    slices, f32 and bf16. ``cli``: ``TP_FRAMES_CLI`` reached run_stop."""
    import torch
    import torch_reference as R
    from repro_torch import weights
    from repro_torch.configs import get_config
    from repro_torch.core import pinit
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.registry import build_model
    from repro_torch.tree import tree_flatten

    meshes = {R.TP_MESH: make_local_mesh(2, device="cpu"),
              (1, 4): make_local_mesh(4, device="cpu")}
    ref = R.load(ref_path)
    out = {}
    cases = [(a, (0, 1)) for a in R.TP_FRAMES_ARCHS] + \
        [(c, (1,)) for c in R.TP_HEAD_CASES]
    for name, dtypes in cases:
        base = R.tp_case_config(get_config, name)
        tpm = meshes[R.TP_HEAD_CASES[name][0] if name in R.TP_HEAD_CASES
                     else R.TP_MESH]
        model = build_model(base)
        toks = R.lm_tokens(base)
        frames = R.lm_frames(base) if base.encoder is not None else None
        params = weights.lm_params_from_jax(ref[name]["params"], base,
                                            "cpu", mesh=tpm)
        for f32 in dtypes:
            r = ref[name][f"f{f32}"]
            _tp_held(out, tpm, f"{name}/f{f32}", model, params, r["run"],
                     toks, f32, frames)
            out[f"{name}/f{f32}/step"] = np.array(
                _tp_step_errors(base, r["train"], tpm, bool(f32)))
        if tpm is meshes[R.TP_MESH]:
            _tp_self(base, tpm, f"self/{name}", out)
    same = True
    for arch in R.TP_FRAMES_ARCHS:
        pd = build_model(get_config(arch).reduced()).param_pd
        for dt in (None, torch.bfloat16):
            mine = pinit.materialize(pd, 7, "cpu", dtype=dt,
                                     mesh=meshes[R.TP_MESH])
            cut = weights.shard_tree(pinit.materialize(pd, 7, "cpu",
                                                       dtype=dt), pd,
                                     meshes[R.TP_MESH])
            same &= all(a.dtype == b.dtype and torch.equal(a, b)
                        for (_, a), (_, b) in zip(tree_flatten(mine),
                                                  tree_flatten(cut)))
    out["pinit"] = np.bool_(same)
    out["cli"] = np.bool_(_cli_ok(TP_FRAMES_CLI, 2))
    for m in meshes.values():
        m.destroy()
    return out


#: ``lm_tp_ckpt``'s run: the reduced qwen1.5-0.5b under ``comm='xla'``,
#: TP_CKPT_BATCH sequences of TP_CKPT_SEQ tokens a step
TP_CKPT_BATCH, TP_CKPT_SEQ = 4, 32
#: ``lm_tp_ckpt``'s CLI runs: two steps at --model-parallel 2 with a
#: checkpoint a step, then a resume at --model-parallel 4 to step 3
TP_CKPT_CLI = ("--arch", "qwen1.5-0.5b", "--reduced", "--comm", "xla",
               "--device", "cpu", "--batch", str(TP_CKPT_BATCH), "--seq",
               str(TP_CKPT_SEQ))


def _npz(path):
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def _ckpt_file(d):
    """The newest committed payload of the checkpoint directory ``d``."""
    from repro_torch.train import checkpoint as ckpt
    return _npz(os.path.join(d, f"ckpt_{ckpt.latest_tag(d)}.npz"))


def _ckpt_whole(state, pd, tpm):
    """A state's params and momentum gathered whole over ``tpm``'s model
    axis, keyed as the checkpoint keys them (``params|…``, ``mom|…``;
    LAMB's ``count`` aside)."""
    from repro_torch.train import checkpoint as ckpt
    out = {}
    for field in ("params", "mom"):
        tree = ckpt._whole(getattr(state, field), pd, tpm)
        out.update({f"{field}|{k}": v.detach().numpy()
                    for k, v in ckpt._flatten(tree).items()
                    if hasattr(v, "detach")})
    return out


def _equal_arrays(a: dict, b: dict) -> bool:
    """The keys of ``a`` all in ``b``, the same bytes, shape and dtype."""
    return all(k in b and a[k].dtype == b[k].dtype
               and a[k].shape == b[k].shape
               and a[k].tobytes() == b[k].tobytes() for k in a)


def lm_tp_ckpt(mesh, ref_dir):
    """Checkpoints under the model axis (ROADMAP §3 fault 3.7, §1 item
    6.2c) on four ranks: the reduced qwen1.5-0.5b under ``comm='xla'`` at
    (data 2, model 2), one step through ``loop.train(ckpt_dir=...)``.

    ``whole``: every split leaf of the committed file has the reference's
    whole shape; ``own``: ``checkpoint.load`` gives this rank its own
    slices (the state's, bit for bit), ``own_sha`` their digest; ``bytes``
    (rank 0): each key's bytes equal those of the file written at model 1
    from the same state gathered whole; ``whole/{key}`` (rank 0): the
    file's arrays; ``ref``: the file the reference saved (``ref_dir``)
    loaded at (2, 2) and gathered is its arrays, bit for bit;
    ``elastic/{m}``: the file resumed at (data 4 / m, model m) for m in 4,
    1 (``elastic.load_resharded``) gathered is the file, bit for bit,
    ``elastic/{m}/finite``: one step from it; ``resume``: a 2-step run
    resumed from the step-1 file at (2, 2) ends on the masters and
    momentum of an uninterrupted one, bit for bit; ``lamb/whole``,
    ``lamb/own``: the same two checks for a LAMB state (its two moments);
    ``explicit``: an explicit schedule's state over the same mesh (whole
    leaves on every rank) saved as it is and loaded back, bit for bit;
    ``cli``: ``TP_CKPT_CLI`` at --model-parallel 2 with --ckpt-dir, then
    --resume-elastic at --model-parallel 4 resumed at step 2 and reached
    run_stop."""
    import contextlib
    import io

    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.core import lars
    from repro_torch.core.schedule import ScheduleConfig, make_schedule
    from repro_torch.data.synthetic import make_batch_fn
    from repro_torch.launch import train as cli
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.common import dp_axes, local_slice
    from repro_torch.models.registry import build_model
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import elastic, loop
    from repro_torch.train.state import TrainState, init_state, \
        sharded_state_kwargs
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import tree_flatten

    root = sys.argv[2]
    cfg = get_config("qwen1.5-0.5b").reduced()
    model = build_model(cfg)
    pd = model.param_pd
    sched = make_schedule(ScheduleConfig(base_lr=0.5, warmup_steps=1,
                                         total_steps=3, decay="poly2"))
    shape = InputShape("t", "train", TP_CKPT_SEQ, TP_CKPT_BATCH)
    tpm = make_local_mesh(2, device="cpu")

    def setup(m, kind="lars"):
        step = make_train_step(model, lars.OptConfig(kind=kind), sched,
                               mesh=m, comm="xla")
        batch_fn = make_batch_fn(cfg, shape, seed=3, device="cpu", mesh=m,
                                 axes=dp_axes(m))
        return step, batch_fn

    def fresh(step, seed=0, kind="lars"):
        return init_state(model, seed, device="cpu", opt_kind=kind,
                          **sharded_state_kwargs(step))

    def run(step, batch_fn, state, steps, d):
        return loop.train(state, step, batch_fn, steps=steps, ckpt_dir=d,
                          ckpt_every=1, log_every=0)[0]

    def leaves(state):
        return [x for f in (state.params, state.mom)
                for _, x in tree_flatten(f)]

    split = {k for k, v in ckpt._flatten(pd).items()
             if local_slice(v, tpm.axis("model"))[0] is not None}
    out = {}
    step, batch_fn = setup(tpm)
    d1 = os.path.join(root, "tp")
    state = run(step, batch_fn, fresh(step), 1, d1)
    data = _ckpt_file(d1)
    whole_shape = {k: tuple(v.shape) for k, v in ckpt._flatten(pd).items()}
    out["whole"] = np.bool_(all(
        data[f"{f}|{k}"].shape == whole_shape[k]
        for f in ("params", "mom") for k in split))
    back = ckpt.load(fresh(step, seed=1), d1, mesh=tpm, param_pd=pd)
    out["own"] = np.bool_(back.step == 1 and all(
        torch.equal(a, b) for a, b in zip(leaves(back), leaves(state))))
    out["own_sha"] = _sha(leaves(back))
    gathered = _ckpt_whole(state, pd, tpm)
    # the model-1 file: the same state gathered whole, written by rank 0
    w_params = ckpt._whole(state.params, pd, tpm)
    w_mom = ckpt._whole(state.mom, pd, tpm)
    d2 = os.path.join(root, "one")
    if mesh.rank == 0:
        ckpt.save(TrainState(state.step, w_params, w_mom), d2,
                  tag=ckpt.step_tag(1))
        one = _npz(os.path.join(d2, f"ckpt_{ckpt.step_tag(1)}.npz"))
        out["bytes"] = np.bool_(set(one) == set(data)
                                and _equal_arrays(one, data))
        out["file_is_state"] = np.bool_(_equal_arrays(gathered, data))
        for k, v in data.items():
            out[f"whole/{k}"] = v

    # the file the reference saved, loaded at (2, 2)
    got = ckpt.load(fresh(step, seed=2), ref_dir, mesh=tpm, param_pd=pd)
    out["ref"] = np.bool_(_equal_arrays(_ckpt_whole(got, pd, tpm),
                                        _ckpt_file(ref_dir)))

    # elastic: (2, 2) -> (1, 4) and (4, 1)
    for m in (4, 1):
        em = make_local_mesh(m, device="cpu")
        estep, ebatch = setup(em)
        s = elastic.load_resharded(d1, fresh(estep, seed=3), None, 1,
                                   mesh=em, param_pd=pd)
        out[f"elastic/{m}"] = np.bool_(
            s.step == 1 and _equal_arrays(_ckpt_whole(s, pd, em), data))
        s, metrics = estep(s, ebatch(s.step))
        out[f"elastic/{m}/finite"] = np.bool_(
            np.isfinite(float(metrics["loss"])))
        em.destroy()

    # a resumed run against an uninterrupted one
    d3 = os.path.join(root, "straight")
    straight = run(step, batch_fn, fresh(step), 2, d3)
    resumed = run(step, batch_fn, ckpt.load(fresh(step, seed=4), d1,
                                            mesh=tpm, param_pd=pd), 2, d1)
    out["resume"] = np.bool_(resumed.step == straight.step == 2 and all(
        torch.equal(a, b) for a, b in zip(leaves(resumed),
                                          leaves(straight))))

    # LAMB: its two moments gathered and cut alike
    lstep, lbatch = setup(tpm, "lamb")
    d4 = os.path.join(root, "lamb")
    lstate = run(lstep, lbatch, fresh(lstep, kind="lamb"), 1, d4)
    ldata = _ckpt_file(d4)
    out["lamb/whole"] = np.bool_(all(
        ldata[f"mom|{x}|{k}"].shape == whole_shape[k]
        for x in "mv" for k in split))
    lback = ckpt.load(fresh(lstep, seed=1, kind="lamb"), d4, mesh=tpm,
                      param_pd=pd)
    out["lamb/own"] = np.bool_(
        lback.mom["count"] == lstate.mom["count"] and all(
            torch.equal(a, b) for f in ("m", "v") for a, b in zip(
                [x for _, x in tree_flatten(lback.mom[f])],
                [x for _, x in tree_flatten(lstate.mom[f])])))

    # an explicit schedule over the same mesh: every leaf whole on every
    # rank, saved and loaded as it is
    xstep = make_train_step(model, lars.OptConfig(), sched, mesh=tpm,
                            comm="psum")
    xbatch = make_batch_fn(cfg, shape, seed=3, device="cpu", mesh=tpm)
    d6 = os.path.join(root, "explicit")
    xstate = run(xstep, xbatch, fresh(xstep), 1, d6)
    xback = ckpt.load(fresh(xstep, seed=1), d6, mesh=tpm)
    out["explicit"] = np.bool_(
        _equal_arrays({f"{f}|{k}": v.numpy() for f in ("params", "mom")
                       for k, v in ckpt._flatten(getattr(xstate, f)).items()},
                      _ckpt_file(d6))
        and all(torch.equal(a, b) for a, b in zip(leaves(xback),
                                                  leaves(xstate))))

    # the CLI: --ckpt-dir at model 2, --resume-elastic at model 4
    d5 = os.path.join(root, "cli")
    first = _cli_ok([*TP_CKPT_CLI, "--model-parallel", "2", "--steps", "2",
                     "--ckpt-dir", d5, "--ckpt-every", "1"], 2)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        history = cli.main([*TP_CKPT_CLI, "--model-parallel", "4",
                            "--steps", "3", "--resume-elastic",
                            "--ckpt-dir", d5])
    losses = [h for h in history if "loss" in h]
    out["cli"] = np.bool_(
        first and "restored step 2" in buf.getvalue()
        and "run_stop" in buf.getvalue() and len(losses) == 1
        and losses[0]["step"] == 2 and np.isfinite(losses[0]["loss"]))
    tpm.destroy()
    return out


#: ``lm_tp_moe``'s CLI runs: the reduced qwen2-moe-a2.7b under --comm xla
#: at --model-parallel 2 and at model 1 over the four ranks
TP_MOE_CLI = ("--arch", "qwen2-moe-a2.7b", "--reduced", "--comm", "xla",
              "--device", "cpu", "--steps", "2", "--batch", "4", "--seq",
              "32")


@contextlib.contextmanager
def _port_routes():
    """Within: each call of the port's ``moe._route`` records, in call
    order, (its expert ids, each token's gap between its k-th and
    (k+1)-th router probabilities, one bf16 ulp of the k-th)."""
    import torch
    from repro_torch.models import moe
    route, ids = moe._route, []

    def recording(x_flat, router_w, e):
        got = route(x_flat, router_w, e)
        with torch.no_grad():
            top = torch.softmax(x_flat.float() @ router_w.float(),
                                dim=-1).sort(dim=-1, descending=True).values
        kth = top[:, e.top_k - 1]
        ids.append((got[1].numpy().copy(),
                    (kth - top[:, e.top_k]).numpy(),
                    (2.0 ** (torch.floor(torch.log2(kth)) - 7)).numpy()))
        return got
    moe._route = recording
    try:
        yield ids
    finally:
        moe._route = route


@contextlib.contextmanager
def _pinned_routes(ids):
    """Within: each call of the port's ``moe._top_k`` (one a MoE layer's
    forward, in call order) returns the next of the given (T, k) expert
    ids ``ids`` in place of its own choice, the gates its own
    probabilities at them; yields a dict that counts ``flips`` (the
    token-layers whose own choice differs) and ``gap``, the largest
    distance between such a token's k-th and (k+1)-th probabilities."""
    import torch
    from repro_torch.models import moe
    real, ids = moe._top_k, list(ids)
    seen = {"flips": 0, "gap": 0.0, "left": ids}

    def top_k(x, k):
        own = real(x, k)[1]
        want = torch.from_numpy(ids.pop(0)).long()
        flip = (own.sort(-1).values != want.sort(-1).values).any(-1)
        if flip.any():
            top = x[flip].sort(-1, descending=True).values
            seen["gap"] = max(seen["gap"],
                              float((top[:, k - 1] - top[:, k]).max()))
        seen["flips"] += int(flip.sum())
        return x.gather(-1, want), want
    moe._top_k = top_k
    try:
        yield seen
    finally:
        moe._top_k = real


def _tp_moe_layer(r, name, tpm, out):
    """The MoE layer of ``torch_reference.TP_MOE_LAYERS[name]`` over
    ``tpm`` (the rank's expert shards, its data rows) against the
    reference's ``r``, as ``{name}/{dtype}/{mode}/...``: ``out`` and
    ``aux`` (the data ranks' mean) over the reference's largest, ``xs``
    (this rank's FFN buffers, the largest difference over the largest
    element) and, in train in f32, ``grads`` (the worst leaf's
    difference over its largest reference gradient: each param summed
    over the data ranks and gathered over ``model``, and x gathered over
    the rows). ``self/{name}``: f32 out and aux against
    ``moe_apply_chunked`` on the whole batch (its answer is the mesh's)."""
    import torch
    import torch.distributed as dist
    import torch_reference as R
    from repro_torch import weights
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.common import model_axis
    cfg = R.moe_case_cfg(get_config, R.TP_MOE_LAYERS[name][0])
    pd = moe.moe_pd(cfg)
    tp, d = model_axis(tpm), tpm.axis("data")
    n = r["x"].shape[0] // d.size
    rows = slice(d.index * n, (d.index + 1) * n)
    me = f"d{d.index}m{tp.index}"

    def data_mean(a):
        a = a.detach().clone()
        if d.size > 1:
            dist.all_reduce(a, group=d.group)
        return float(a) / d.size

    for dt in ("float32", "bfloat16"):
        whole = {k: torch.from_numpy(v).to(getattr(torch, dt))
                 for k, v in r["params"].items()}
        p = weights.shard_tree(whole, pd, tpm)
        x = torch.from_numpy(r["x"][rows]).to(whole["router"].dtype)
        for mode in ("train", "decode"):
            want, key = r[dt][mode], f"{name}/{dt}/{mode}"
            seen, ffn = [], moe._expert_ffn

            def capturing(wg, wu, wd, xs):
                seen.append(xs.float().clone())
                return ffn(wg, wu, wd, xs)
            moe._expert_ffn = capturing
            try:
                with torch.no_grad():
                    o, a = moe.moe_apply(p, x, cfg, decode=mode == "decode",
                                         tp=tp)
            finally:
                moe._expert_ffn = ffn
            out[f"{key}/out"] = _rel(_rows(o.float(), d), want["out"])
            out[f"{key}/aux"] = abs(data_mean(a) - float(want["aux"])) \
                / abs(float(want["aux"]))
            if mode == "train":
                out[f"{key}/xs"] = _rel(seen[0], want["xs"][me])
            if mode != "train" or dt != "float32":
                continue
            leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
            xg = x.clone().requires_grad_()
            o, a = moe.moe_apply(leaves, xg, cfg, decode=False, tp=tp)
            ((o * torch.from_numpy(want["ct"][rows])).sum()
             + 0.01 / d.size * a).backward()
            grads = {k: v.grad for k, v in leaves.items()}
            for g in grads.values():
                if d.size > 1:
                    dist.all_reduce(g, group=d.group)
            grads = weights.gather_tree(grads, pd, tpm)
            errs = [_rel(grads[k], want["grads"][k]) for k in grads]
            errs.append(_rel(_rows(xg.grad, d), want["grads"]["x"]))
            out[f"{key}/grads"] = max(errs)
            # the padded experts of the stack (none on "cap") get none
            out[f"{key}/dead"] = np.bool_(not any(
                bool(g[cfg.moe.n_routed:].any()) for k, g in grads.items()
                if k != "router"))
    # the mesh's layer against the one-device chunked function, in f32
    whole = {k: torch.from_numpy(v) for k, v in r["params"].items()}
    x = torch.from_numpy(r["x"])
    for mode in ("train", "decode"):
        with torch.no_grad():
            o, a = moe.moe_apply(weights.shard_tree(whole, pd, tpm),
                                 x[rows], cfg, decode=mode == "decode",
                                 tp=tp)
            o1, a1 = moe.moe_apply_chunked(whole, x, cfg,
                                           decode=mode == "decode",
                                           data=d.size, model=tp.size)
        out[f"self/{name}/{mode}"] = np.array(
            [_rel(_rows(o, d), o1.numpy()),
             abs(data_mean(a) - float(a1)) / abs(float(a1))])


def _moe_ckpt(tpm, root, out, arch="qwen2-moe-a2.7b"):
    """A MoE state of ``arch`` (reduced) at (data 2, model 2), one
    ``comm='xla'`` step through
    ``loop.train`` with a checkpoint: ``ckpt/bytes`` (rank 0: the file
    equals, key by key, the model-1 file of the same state gathered whole)
    and ``ckpt/elastic`` (loaded at (1, 4) by ``elastic.load_resharded``,
    the state gathered is the file, bit for bit)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.core import lars
    from repro_torch.core.schedule import ScheduleConfig, make_schedule
    from repro_torch.data.synthetic import make_batch_fn
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.common import dp_axes
    from repro_torch.models.registry import build_model
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import elastic, loop
    from repro_torch.train.state import TrainState, init_state, \
        sharded_state_kwargs
    from repro_torch.train.step import make_train_step
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    pd = model.param_pd
    sched = make_schedule(ScheduleConfig(base_lr=0.5, warmup_steps=1,
                                         total_steps=3, decay="poly2"))
    shape = InputShape("t", "train", TP_CKPT_SEQ, TP_CKPT_BATCH)

    def fresh(step, seed):
        return init_state(model, seed, device="cpu",
                          **sharded_state_kwargs(step))

    step = make_train_step(model, lars.OptConfig(), sched, mesh=tpm,
                           comm="xla")
    d1 = os.path.join(root, "moe_ckpt")
    state = loop.train(fresh(step, 0), step, make_batch_fn(
        cfg, shape, seed=3, device="cpu", mesh=tpm, axes=dp_axes(tpm)),
        steps=1, ckpt_dir=d1, ckpt_every=1, log_every=0)[0]
    data = _ckpt_file(d1)
    whole = TrainState(state.step, ckpt._whole(state.params, pd, tpm),
                       ckpt._whole(state.mom, pd, tpm))
    if tpm.rank == 0:
        d2 = os.path.join(root, "moe_one")
        ckpt.save(whole, d2, tag=ckpt.step_tag(1))
        one = _npz(os.path.join(d2, f"ckpt_{ckpt.step_tag(1)}.npz"))
        out["ckpt/bytes"] = np.bool_(set(one) == set(data)
                                     and _equal_arrays(one, data))
    em = make_local_mesh(4, device="cpu")
    estep = make_train_step(model, lars.OptConfig(), sched, mesh=em,
                            comm="xla")
    s = elastic.load_resharded(d1, fresh(estep, 3), None, 1, mesh=em,
                               param_pd=pd)
    out["ckpt/elastic"] = np.bool_(
        s.step == 1 and _equal_arrays(_ckpt_whole(s, pd, em), data))
    em.destroy()


@contextlib.contextmanager
def _moe_chunked(data: int = 1, model: int = 1):
    """Within: the MoE layer as ``moe.moe_apply_chunked`` at (data,
    model), the mesh's answer on one device (the transformer calls
    ``moe.moe_apply`` by name; the stand-in takes ``tp`` and ignores
    it)."""
    from repro_torch.models import moe
    real = moe.moe_apply

    def chunked(p, x, cfg, *, decode, tp=None):
        return moe.moe_apply_chunked(p, x, cfg, decode=decode, data=data,
                                     model=model)
    moe.moe_apply = chunked
    try:
        yield
    finally:
        moe.moe_apply = real


def _moe_xla_dp(out):
    """``comm='xla'`` at (data 4, model 1): each rank routes its own row
    with its own capacity; two f32 LARS steps against the one-rank step on
    the whole batch with the layer chunked alike (``_moe_chunked(4, 1)``):
    ``xla_dp`` = (loss relative, masters over the largest update)."""
    import torch_reference as R
    from repro_torch.configs import get_config
    from repro_torch.core import lars, precision
    from repro_torch.core.schedule import ScheduleConfig, make_schedule
    from repro_torch.data.synthetic import token_batch
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import moe
    from repro_torch.models.registry import build_model
    from repro_torch.train.state import init_state
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import tree_flatten
    cfg = get_config(R.MOE_ARCH).reduced()
    model = build_model(cfg)
    sched = make_schedule(ScheduleConfig(**R.LR))
    dm = make_local_mesh(1, device="cpu")
    d = dm.axis("data")
    one, four = (make_train_step(model, lars.OptConfig(), sched, mesh=m,
                                 comm="xla", comm_dtype="f32")
                 for m in (None, dm))
    s1, s = (init_state(model, 5, device="cpu") for _ in range(2))
    p0 = dict(tree_flatten(s1.params))
    n = R.LM_TRAIN_BATCH // d.size
    worst = [0.0, 0.0]
    for k in range(R.LM_TRAIN_STEPS):
        batch = token_batch(cfg, batch=R.LM_TRAIN_BATCH, seq=R.LM_TRAIN_SEQ,
                            step=k, kind="lcg", device="cpu")
        with precision.f32_compute():
            with _moe_chunked(data=d.size):
                s1, m1 = one(s1, batch)
            s, m = four(s, {x: v[d.index * n:(d.index + 1) * n]
                            for x, v in batch.items()})
        worst[0] = max(worst[0], abs(float(m["loss"]) - float(m1["loss"]))
                       / abs(float(m1["loss"])))
    got, want = dict(tree_flatten(s.params)), dict(tree_flatten(s1.params))
    upd = max(float((want[p] - p0[p]).abs().max()) for p in want)
    worst[1] = max(float((got[p] - want[p]).abs().max()) for p in want) / upd
    out["xla_dp"] = np.array(worst)
    dm.destroy()


def lm_tp_moe(mesh, ref_paths):
    """The MoE layer's experts over the model axis (ROADMAP §1 item 6.3)
    on four ranks, against the reference's GSPMD runs
    (``torch_reference.py tp_moe_cases``' parts, read from the
    comma-separated ``ref_paths``): the
    layer cases of ``torch_reference.TP_MOE_LAYERS`` on (data 2, model 2)
    and (1, 4) (``_tp_moe_layer``); the reduced qwen2-moe-a2.7b at (2, 2)
    in bf16 and f32 (``lm/f{f32}/...``): ``_tp_held``'s outputs and ties
    (the full forward over the prompt), ``step`` (``_tp_step_errors``:
    loss, masters, momentum) and ``routes`` (every layer's expert ids of
    both steps against the reference's device's: (as many layers, equal
    but at a bf16 tie, the choices that differ)). Within the
    port, in f32: ``self/lm/...`` (``_tp_self`` at (2, 2) against the
    one-device port with the layer chunked as the mesh chunks it),
    ``xla_dp`` (``_moe_xla_dp``), the checkpoint (``_moe_ckpt``); ``cli``:
    ``TP_MOE_CLI`` at --model-parallel 2, and at model 1, reached
    run_stop."""
    import functools

    import torch_reference as R
    from repro_torch import weights
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import moe
    from repro_torch.models.registry import build_model

    meshes = {R.TP_MESH: make_local_mesh(2, device="cpu"),
              (1, 4): make_local_mesh(4, device="cpu")}
    ref = {}
    for path in ref_paths.split(","):
        ref.update(R.load(path))
    out = {}
    for name, (_, shape, _) in R.TP_MOE_LAYERS.items():
        _tp_moe_layer(ref[name], name, meshes[shape], out)
    tpm = meshes[R.TP_MESH]
    base = get_config(R.MOE_ARCH).reduced()
    model = build_model(base)
    toks = R.lm_tokens(base)
    params = weights.lm_params_from_jax(ref["lm"]["params"], base, "cpu",
                                        mesh=tpm)
    me = f"d{tpm.axis('data').index}m{tpm.axis('model').index}"
    for f32 in (0, 1):
        r = ref["lm"][f"f{f32}"]
        _tp_held(out, tpm, f"lm/f{f32}", model, params, r["run"], toks, f32,
                 train_len=R.LM_PROMPT)
        with _port_routes() as ids:
            out[f"lm/f{f32}/step"] = np.array(
                _tp_step_errors(base, r["train"], tpm, bool(f32)))
        want = [r["train"][f"s{k}"]["route"][f"l{i}"][me]
                for k in range(R.LM_TRAIN_STEPS)
                for i in range(base.n_layers)]
        flips = [(a != b).any(-1) for (a, _, _), b in zip(ids, want)]
        out[f"lm/f{f32}/routes"] = np.array([
            len(ids) == len(want), all(
                # in bf16 a choice may flip only at a tie: its k-th and
                # (k+1)-th probabilities within one bf16 ulp of the k-th
                not f.any() or (not f32 and bool((gap[f] <= ulp[f]).all()))
                for f, (_, gap, ulp) in zip(flips, ids)),
            sum(int(f.sum()) for f in flips)])
    _tp_self(base, tpm, "self/lm", out, train_len=R.LM_PROMPT,
             one=functools.partial(_moe_chunked, *R.TP_MESH))
    _moe_ckpt(tpm, sys.argv[2], out)
    _moe_xla_dp(out)
    out["cli"] = np.bool_(
        _cli_ok([*TP_MOE_CLI, "--model-parallel", "2"], 2)
        and _cli_ok(TP_MOE_CLI, 2))
    for m in meshes.values():
        m.destroy()
    return out


#: ``lm_tp_mla``'s CLI run: the reduced deepseek-v2-236b under --comm xla
#: at --model-parallel 2 over the four ranks
TP_MLA_CLI = ("--arch", "deepseek-v2-236b", "--reduced", "--comm", "xla",
              "--model-parallel", "2", "--device", "cpu", "--steps", "2",
              "--batch", "4", "--seq", "32")


def _tp_mla_block(r, inputs, name, tpm, out):
    """The MLA block of ``torch_reference.TP_MLA_BLOCKS[name]`` over
    ``tpm`` (the rank's columns of ``wq``, ``wk_b``, ``wv_b`` and rows of
    ``wo``, ``wkv_a`` and ``ckv_norm`` whole; its data rows) against the
    reference's ``r``, each figure the worst difference over the
    reference's largest, gathered over the data ranks: ``{name}/{dt}/
    prefill`` (out and the whole latent cache), ``{name}/{dt}/decode``
    (the absorbed decode from the reference's prefill cache: out and the
    cache with its new row), and where the reference has them ``{name}/
    bfloat16/flash`` (the prefill through K5's plain version on the rank's
    heads) and ``{name}/grads`` (the f32 gradients of ``sum(out · ct)``:
    each param summed over the data ranks, the split ones gathered over
    ``model``, the replicated ones this rank's own; and x)."""
    import dataclasses

    import torch
    import torch.distributed as dist
    import torch_reference as R
    from repro_torch import weights
    from repro_torch.configs import get_config
    from repro_torch.models import attention as attn
    from repro_torch.models.common import model_axis
    cfg = get_config(R.MLA_ARCH).reduced()
    pd = attn.mla_pd(cfg)
    tp, d = model_axis(tpm), tpm.axis("data")
    n = R.LM_BATCH // d.size
    rows = slice(d.index * n, (d.index + 1) * n)
    positions = torch.arange(R.LM_PROMPT)[None]
    cache_of = lambda c: max(_rel(_rows(c[k].float(), d), want["cache"][k])
                             for k in ("ckv", "krope"))
    for dt in ("float32", "bfloat16"):
        dtype = getattr(torch, dt)
        p = weights.shard_tree({k: torch.from_numpy(v).to(dtype) for k, v
                                in inputs["params"].items()}, pd, tpm)
        x, xd = (torch.from_numpy(inputs[k][rows]).to(dtype)
                 for k in ("x", "x_dec"))
        with torch.no_grad():
            want = r[dt]["prefill"]
            o, cache = attn.mla_parallel(p, x, positions, cfg,
                                         cache_len=R.LM_CACHE, tp=tp)
            out[f"{name}/{dt}/prefill"] = max(
                _rel(_rows(o.float(), d), want["out"]), cache_of(cache))
            cache = {k: torch.from_numpy(v[rows]).to(dtype)
                     for k, v in want["cache"].items()}
            want = r[dt]["decode"]
            o, cache = attn.mla_decode(p, xd, R.LM_PROMPT, cfg, cache,
                                       tp=tp)
            out[f"{name}/{dt}/decode"] = max(
                _rel(_rows(o.float(), d), want["out"]), cache_of(cache))
            if "flash" in r[dt]:
                o, _ = attn.mla_parallel(p, x, positions, dataclasses.replace(
                    cfg, flash_attention=True), tp=tp)
                out[f"{name}/{dt}/flash"] = _rel(_rows(o.float(), d),
                                                 r[dt]["flash"])
        if dt != "float32" or "grads" not in r:
            continue
        leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
        xg = x.clone().requires_grad_()
        o, _ = attn.mla_parallel(leaves, xg, positions, cfg, tp=tp)
        (o * torch.from_numpy(r["ct"][rows])).sum().backward()
        grads = {k: v.grad for k, v in leaves.items()}
        for g in grads.values():
            if d.size > 1:
                dist.all_reduce(g, group=d.group)
        grads = weights.gather_tree(grads, pd, tpm)
        out[f"{name}/grads"] = max(
            [_rel(grads[k], r["grads"][k]) for k in grads]
            + [_rel(_rows(xg.grad, d), r["grads"]["x"])])


def lm_tp_mla(mesh, ref_paths):
    """MLA over the model axis (ROADMAP §1 item 6.3's MLA part) on four
    ranks, against the reference's GSPMD runs (``torch_reference.py
    tp_mla_cases``' parts, read from the comma-separated ``ref_paths``):
    the block cases of ``torch_reference.TP_MLA_BLOCKS`` on (data 2, model
    2) and (1, 4) (``_tp_mla_block``); the reduced deepseek-v2-236b at
    (2, 2) in bf16 and f32 (``lm/f{f32}/...``): ``_tp_held``'s outputs and
    ties (the full forward over the prompt), ``step`` (``_tp_step_errors``)
    and ``routes``: in f32 (as many layers, every layer's expert ids the
    reference device's), in bf16 the steps run on the reference device's
    choices (``_pinned_routes``: all consumed, the port's own choices that
    differ, their largest probability gap); ``dp/step``: two f32 steps at
    (data 4, model 1) from the reference's inputs. Within the port, in
    f32: ``self/lm/...`` (``_tp_self`` at (2, 2) against the one-device
    port with the MoE layer chunked as the mesh chunks it), the checkpoint
    (``_moe_ckpt``); ``cli``: ``TP_MLA_CLI`` reached run_stop."""
    import functools

    import torch_reference as R
    from repro_torch import weights
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.registry import build_model

    def merge(into, tree):
        for k, v in tree.items():
            if isinstance(v, dict) and k in into:
                merge(into[k], v)
            else:
                into[k] = v
        return into

    meshes = {R.TP_MESH: make_local_mesh(2, device="cpu"),
              (1, 4): make_local_mesh(4, device="cpu"),
              R.TP_MLA_DP: make_local_mesh(1, device="cpu")}
    ref = {}
    for path in ref_paths.split(","):
        merge(ref, R.load(path))        # the parts share the "lm" subtree
    out = {}
    for name, shape in R.TP_MLA_BLOCKS.items():
        _tp_mla_block(ref[name], ref["inputs"], name, meshes[shape], out)
    tpm = meshes[R.TP_MESH]
    base = get_config(R.MLA_ARCH).reduced()
    model = build_model(base)
    toks = R.lm_tokens(base)
    params = weights.lm_params_from_jax(ref["lm"]["params"], base, "cpu",
                                        mesh=tpm)
    me = f"d{tpm.axis('data').index}m{tpm.axis('model').index}"
    for f32 in (0, 1):
        r = ref["lm"][f"f{f32}"]
        _tp_held(out, tpm, f"lm/f{f32}", model, params, r["run"], toks, f32,
                 train_len=R.LM_PROMPT)
        want = [r["train"][f"s{k}"]["route"][f"l{i}"][me]
                for k in range(R.LM_TRAIN_STEPS)
                for i in range(base.n_layers)]
        if f32:
            with _port_routes() as ids:
                out["lm/f1/step"] = np.array(
                    _tp_step_errors(base, r["train"], tpm, True))
            out["lm/f1/routes"] = np.array([len(ids) == len(want), all(
                np.array_equal(a, b) for (a, _, _), b in zip(ids, want))])
            continue
        # bf16: on the reference device's expert choices
        with _pinned_routes(want) as pin:
            out["lm/f0/step"] = np.array(
                _tp_step_errors(base, r["train"], tpm, False))
        out["lm/f0/routes"] = np.array([not pin["left"], pin["flips"],
                                        pin["gap"]])
    out["dp/step"] = np.array(_tp_step_errors(
        base, ref["dp"]["train"], meshes[R.TP_MLA_DP], True))
    _tp_self(base, tpm, "self/lm", out, train_len=R.LM_PROMPT,
             one=functools.partial(_moe_chunked, *R.TP_MESH))
    _moe_ckpt(tpm, sys.argv[2], out, arch=R.MLA_ARCH)
    out["cli"] = np.bool_(_cli_ok(list(TP_MLA_CLI), 2))
    for m in meshes.values():
        m.destroy()
    return out


SCENARIOS = {"schedules": schedules, "zero1_step": zero1_step,
             "zero23_step": zero23_step, "ckpt_zero1": ckpt_zero1,
             "lm_zero1": lm_zero1, "lm_family_dp": lm_family_dp,
             "lm_tp": lm_tp, "lm_xla_dp": lm_xla_dp,
             "lm_tp_recurrent": lm_tp_recurrent, "xla_conv": xla_conv,
             "lm_tp_frames": lm_tp_frames, "lm_tp_ckpt": lm_tp_ckpt,
             "lm_tp_moe": lm_tp_moe, "lm_tp_mla": lm_tp_mla}


def main(scenario: str, out_dir: str, device: str = "cpu"):
    """``scenario`` names a SCENARIOS entry, with ``:ARG`` for one that
    takes an argument (``lm_family_dp:zamba2-7b``, ``lm_tp:REF.npz``)."""
    import torch
    from repro_torch.launch.mesh import make_local_mesh
    # the same graph must give the same numbers in both steps compared
    torch.backends.cudnn.deterministic = True
    mesh = make_local_mesh(device="cpu" if device == "cpu" else None)
    name, _, arg = scenario.partition(":")
    try:
        out = SCENARIOS[name](mesh, *([arg] if arg else []))
        np.savez(os.path.join(out_dir, f"rank{mesh.rank}.npz"), **out)
    finally:
        mesh.destroy()


if __name__ == "__main__":
    main(*sys.argv[1:])
