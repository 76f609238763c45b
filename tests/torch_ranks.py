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


def schedules(mesh):
    """Every schedule, post-backward and in-backward, all-reduce and
    reduce-scatter forms, against the naive mean of the ranks' gradients
    (rank r's are ``tree * (1 + 0.1 r)``), f32 wire. Returns the
    reduce-scatter shards for the cross-rank and reference checks."""
    import torch
    import torch_reference
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
    # rank r's chunk of the packed, rotated naive mean
    naive_rows = [bucketing.rotate_to_shards(b, n).reshape(n, -1)[r]
                  for b in bucketing.pack(naive, plan, dtype=torch.float32)]
    out = {}
    for strategy in ("psum", "ring", "bucketed"):
        kw = dict(strategy=strategy, axes=mesh.axes,
                  comm_dtype=torch.float32)
        # post-backward all-reduce
        red = ddp.allreduce_grads(g_r, plan=plan, **kw)
        for (p, a), (_, b) in zip(tree_flatten(red), tree_flatten(naive)):
            assert _maxdiff(a, b) <= TOL, (strategy, "allreduce", p)
        # in-backward all-reduce: d/dp sum(p * g_r) = g_r
        leaves = [x.clone().requires_grad_() for _, x in tree_flatten(tree)]
        wrapped = ddp.wrap_params_for_overlap(tree_unflatten(paths, leaves),
                                              plan, **kw)
        loss = sum((x * g).sum() for (_, x), (_, g) in
                   zip(tree_flatten(wrapped), tree_flatten(g_r)))
        for x, (p, b) in zip(torch.autograd.grad(loss, leaves),
                             tree_flatten(naive)):
            assert _maxdiff(x, b) <= TOL, (strategy, "overlap", p)
        # post-backward reduce-scatter: rank r's chunk of the naive mean
        shards = ddp.reduce_scatter_grads(g_r, plan=plan, **kw)
        for b, (a, w) in enumerate(zip(shards, naive_rows)):
            assert _maxdiff(a, w) <= TOL, (strategy, "rs", b)
            out[f"{strategy}/{b}"] = a.cpu().numpy()

        # in-backward reduce-scatter (gradient sinks) == post-backward
        def local_loss(p):
            return sum((torch.sin(x * (1.0 + 0.1 * r)) * x).sum()
                       for _, x in tree_flatten(p))
        sinks = ddp.make_shard_sinks(plan, n, device=mesh.device)
        got = torch.autograd.grad(local_loss(ddp.wrap_params_for_overlap(
            tree, plan, shard_sinks=sinks, **kw)), sinks)
        leaves = [x.clone().requires_grad_() for _, x in tree_flatten(tree)]
        grads = torch.autograd.grad(
            local_loss(tree_unflatten(paths, leaves)), leaves)
        want = ddp.reduce_scatter_grads(tree_unflatten(paths, grads),
                                        plan=plan, **kw)
        for b, (a, w) in enumerate(zip(got, want)):
            assert _maxdiff(a, w) <= TOL, (strategy, "in-bwd rs", b)
    return out


#: (schedule, overlap, update_kernel) of the 2-rank ZeRO-1 check
ZERO1_CASES = (("psum", False, False), ("psum", True, True),
               ("ring", True, False), ("ring", False, True))


def zero1_step(mesh):
    """Reduced ResNet-50 on ``mesh``: the ZeRO-1 step against the
    replicated explicit step of the same schedule, f32 wire, for each of
    ``ZERO1_CASES``; two steps, each from the replicated step's state.
    Returns the largest master and momentum differences, each relative to
    its tensor's max (absolute below 1)."""
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
    # each factor both ways, in four of the eight combinations
    for strategy, overlap, kernel in ZERO1_CASES:
        kw = dict(strategy=strategy, bucket_mb=0.02,
                  wire_dtype="f32", overlap=overlap)
        repl = make_train_step(model, opt, sched, mesh=mesh,
                               comm=CommConfig(**kw))
        zero = make_train_step(model, opt, sched, mesh=mesh,
                               comm=CommConfig(sharding="zero1",
                                               update_kernel=kernel,
                                               **kw))
        plan, n = zero.bucket_plan, zero.n_shards
        assert n == mesh.size and plan.n_buckets > 10
        index = mesh.axis(zero.shard_axis).index
        read = make_params_reader(zero)
        s = st.init_state(model, 0, device=mesh.device)
        worst = 0.0
        for k in range(2):
            packed = lambda tree: st.local_shards(
                st.init_packed_shards(tree, plan, n), n, index)
            zs = st.TrainState(s.step, s.params, packed(s.mom),
                               s.bn_state, packed(s.params))
            batch = batch_fn(k)
            s, _ = repl(s, batch)
            zs, _ = zero(zs, batch)
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
                    assert d <= TOL, (strategy, overlap, kernel, k,
                                      p, d)
                    worst = max(worst, d)
        out[f"{strategy}/o{int(overlap)}u{int(kernel)}"] = \
            np.float64(worst)
    return out


SCENARIOS = {"schedules": schedules, "zero1_step": zero1_step}


def main(scenario: str, out_dir: str, device: str = "cpu"):
    import torch
    from repro_torch.launch.mesh import make_local_mesh
    # the same graph must give the same numbers in both steps compared
    torch.backends.cudnn.deterministic = True
    mesh = make_local_mesh(device="cpu" if device == "cpu" else None)
    try:
        out = SCENARIOS[scenario](mesh)
        np.savez(os.path.join(out_dir, f"rank{mesh.rank}.npz"), **out)
    finally:
        mesh.destroy()


if __name__ == "__main__":
    main(*sys.argv[1:])
