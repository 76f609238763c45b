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


SCENARIOS = {"schedules": schedules, "zero1_step": zero1_step,
             "zero23_step": zero23_step, "ckpt_zero1": ckpt_zero1,
             "lm_zero1": lm_zero1, "lm_family_dp": lm_family_dp}


def main(scenario: str, out_dir: str, device: str = "cpu"):
    """``scenario`` names a SCENARIOS entry, with ``:ARG`` for one that
    takes an argument (``lm_family_dp:zamba2-7b``)."""
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
