"""Train/eval steps (a port of ``repro.train.step``).

The loss is label-smoothed cross entropy (paper §III-A.2), the optimizer
LARS or momentum-SGD (paper §III-A.1) on fp32 masters with bf16 compute
(paper §IV). For the LM families the loss's per-row NLL runs through the
smoothed cross-entropy kernel (``kernels/ops.smoothed_xent_rows``, K4,
forward and backward) and the masked mean stays outside it. Two
distribution paths:

* ``comm='xla'``: the reference's GSPMD step. Gradients are taken
  with respect to the bf16 compute copy of the weights, as in the
  reference: each bf16 copy is an autograd leaf of its own, not a cast of
  the master that autograd follows, so the gradients arrive in bf16 and
  the optimizer upcasts them. Without a mesh it runs on one device. Over
  a ``(data, model)`` mesh (``launch.mesh.make_local_mesh(M)``; ROADMAP §1
  items 6.2, 6.2b, 6.2c and 6.3's experts) the leaves of the dense
  decoder, the MoE decoder (its expert stacks on their expert dim; each
  rank's layer routes its own rows' sequence chunk with its own capacity,
  as the reference's ``shard_map`` does), the hybrid, the xLSTM, whisper
  and the VLM split over ``model`` by their specs (the
  VLM's labels IGNORE-padded over its image prefix; the state holds a rank's
  shards: ``init_state(..., **sharded_state_kwargs(step))``), each rank
  takes the rows of its data index, the forward and backward run the
  model axis's collectives (``models/common.py``), the gradients are
  meaned over the data axes only (in f32), LARS and LAMB take
  whole-tensor norms (the split leaves' squares summed over ``model``)
  and the guard counts and sums every rank's shards once. At M = 1 it is
  GSPMD's pure data parallelism. As the reference's loss is the global
  masked mean, the port's is the data ranks' mean of their masked means:
  the same where the ranks hold equal label counts, as every token batch
  gives them. The conv family splits no leaf (at M > 1 every model rank
  of a data row computes the same step) and takes its BatchNorm
  statistics over the data axes' global batch (``models/resnet.py``), so
  its new running statistics are the same on every rank.
* an explicit data-parallel schedule (``naive``, ``psum``, ``bucketed``,
  ``ring``, ``hierarchical``, ``2d_torus``, ``dbtree``; paper §III-C)
  over a ``launch.mesh`` mesh: the gradients of the fp32 params are packed
  into static buckets and reduced bucket by bucket, from inside the
  backward (``CommConfig.overlap``, the default) or after it (``naive``:
  one all-reduce a tensor after the backward, replicated only).
  ``CommConfig.use_kernel`` runs the ring folds through K3. The sharded
  rungs reduce-scatter instead and update this rank's fp32 master shards
  (``lars.sharded_update_from_shards``: the batched-norm kernel for the
  trust norms, and with ``update_kernel=True`` the fused update kernel):
  ``zero1`` keeps them across steps and all-gathers the params ahead of
  the next forward (``gather='ahead'``, the default) or at the end of the
  step; ``zero2`` keeps the replicated params as the masters and writes
  them back with an fp32 all-gather at the end of the step; ``zero3``
  keeps no params at all and all-gathers each bucket group inside the
  forward (and again in the backward, ``gather='per_group'``, the
  default). Batch statistics stay per rank; the BN buffers and the
  metrics are averaged over ranks.

``bucket_mb='auto'`` sizes the buckets with ``comm.autotune`` against
the alpha-beta cost model of the mesh (the card's constants,
``launch/hw.py``), from the FLOPs model of the backward or, with
``backward_profile='measured'`` and a ``profile_batch``, from one profiled
warm-up backward (``_measure_profile``). Every LM family but the MoE
runs every explicit schedule and rung as the conv family does, as the
reference's explicit step runs them (the model without a mesh): the
dense decoders (qwen1.5-0.5b and its variants), the hybrid (zamba2-7b),
the xLSTM (xlstm-125m), whisper (frames split with the batch) and the
prefix VLM (internvl2-2b; each rank's loss is the masked mean over its own
labels, and the step means the ranks' means, as the reference's pmean
does: the global mean where the ranks hold equal label counts, as the
token batches give them). Their stacked leaves (one ``(L, ...)`` tensor
per weight kind) split across buckets by the dozen, and their gradients,
like the tied embedding's, are whole only when the backward ends, so
those collectives fire after it (as in the reference, whose ``lax.scan``
does the same), and so do the hybrid's shared block's, whose gradient
sums over every application, the first of them at the forward's start;
the xLSTM's per-layer leaves reduce inside the backward, a layer at a
time. The MoE family (qwen2-moe-a2.7b, deepseek-v2-236b) is refused on
these schedules: the reference's explicit step runs the model without a
mesh, and its MoE layer runs only inside ``shard_map`` over one, so the
reference has no such step to port (``comm='xla'`` trains the family).

``guard=True`` arms the numerical-integrity sentinel (``train/guard.py``)
on every path: the step takes ``(state, batch, guard_in)`` and, before it
writes anything, counts the nonfinite entries of the loss and the reduced
gradient; a bad step returns its input state untouched (no norm or update
kernel launched) with ``skipped`` 1. ``tracer`` (``obs.trace.Tracer``)
stamps the explicit steps' ``forward``/``backward``/``update`` spans and
each bucket's collective. Both off (the defaults) leave the step as it
was.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.comm import primitives as prim
from repro_torch.configs.base import CommConfig
from repro_torch.core import bucketing, ddp, lars
from repro_torch.core.label_smoothing import IGNORE, smoothed_xent, \
    top1_accuracy
from repro_torch.core.precision import cast_to_compute, compute_dtype
from repro_torch.kernels import ops
from repro_torch.models.common import local_slice
from repro_torch.models.resnet import resnet_forward
from repro_torch.obs.trace import mark
from repro_torch.train import guard as guard_lib
from repro_torch.train.state import TrainState
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten


def _lm_loss(logits, labels, *, smoothing):
    """The reference's LM loss: ``smoothed_xent`` with its per-row NLL from
    the K4 wrapper (labels clamped to 0 where IGNORE), then the masked mean.
    Labels narrower than the logits (the VLM: its image prefix's positions
    carry none) are left-padded with IGNORE. Returns (mean loss,
    n_valid)."""
    pad = logits.shape[1] - labels.shape[1]
    if pad:
        labels = torch.cat([labels.new_full((labels.shape[0], pad), IGNORE),
                            labels], dim=1)
    valid = labels != IGNORE
    safe = torch.where(valid, labels, 0)
    nll = ops.smoothed_xent_rows(logits.reshape(-1, logits.shape[-1]),
                                 safe.reshape(-1), smoothing)
    n_valid = valid.sum()
    loss = torch.where(valid.reshape(-1), nll, 0.0).sum() \
        / n_valid.clamp(min=1)
    return loss, n_valid


def make_loss_fn(model, *, smoothing: float = 0.1, aux_coef: float = 0.01,
                 mesh=None):
    xent = smoothed_xent if model.cfg.family == "conv" else _lm_loss

    def loss_fn(params, batch, bn_state=None):
        (logits, aux), new_bn = model.forward_train(params, batch, bn_state,
                                                    mesh)
        loss, _ = xent(logits, batch["labels"], smoothing=smoothing)
        total = loss + aux_coef * aux
        # the VLM's labels are narrower than its logits; the JAX package
        # then counts no label at all, so its accuracy reads 0 (ROADMAP §3)
        labels = batch["labels"]
        if labels.shape != logits.shape[:-1]:
            labels = labels.new_full(logits.shape[:-1], IGNORE)
        acc = top1_accuracy(logits.detach(), labels)
        metrics = {"loss": loss.detach(), "aux": aux.detach(), "acc": acc}
        return total, (metrics, new_bn)

    return loss_fn


def make_train_step(model, opt_cfg: lars.OptConfig, schedule, *,
                    smoothing: float = 0.1, mesh=None, comm="xla",
                    bucket_mb: float = 4.0, comm_dtype: str = "bf16",
                    grad_accum: int = 1, profile_batch=None, tracer=None,
                    guard: bool = False, donate: bool = False):
    """Returns train_step(state, batch) -> (state, metrics).

    ``comm`` is a strategy name ('xla', 'naive', 'psum', 'bucketed',
    'ring', 'hierarchical', '2d_torus', 'dbtree') or a full
    ``CommConfig``. 'xla' runs on one device (``mesh`` None) or over a
    ``(data, model)`` mesh (the module's docstring);
    ``comm_dtype='bf16'`` then differentiates the bf16 compute copy, 'f32'
    the fp32 masters, and ``grad_accum`` splits the batch into that many
    microbatches, chains the BN statistics through them and means the f32
    gradients and the metrics, as the reference's scan does.

    The explicit schedules need a ``mesh`` (``launch.mesh.make_mesh``)
    and every rank calls the step with its own slice of the batch.
    ``profile_batch`` (a batch as this rank's step takes it) enables
    ``backward_profile='measured'`` for ``bucket_mb='auto'``. A
    sharded rung needs the packed state (``init_state(...,
    **train.state.sharded_state_kwargs(train_step))``); the step updates
    the shards in place when ``update_kernel`` is set, so the input state is
    consumed. Full params are read through
    ``train.loop.make_params_reader``.

    ``donate=True`` (comm='xla'): the step consumes its input state, as
    the reference's loop donates it to its jitted step; the LARS and
    momentum-SGD update writes the new masters and momentum into it
    (``lars.update(..., inplace=True)``), so the step allocates no second
    copy of them. The caller must not read the input state afterwards.

    ``guard=True`` returns ``train_step(state, batch, guard_in)`` with
    ``guard_in = {'lr_scale', 'loss_scale'}`` (``guard.neutral_inputs()``
    on the happy path); its metrics gain ``gnorm``, ``nonfinite`` and
    ``skipped``, and a skipped step returns the input state. ``tracer``
    stamps the explicit steps' spans. The step carries ``.guarded``.

    Metrics are 0-d tensors on the batch's device; ``lr`` and the guard's
    rows 0-d f32 CPU tensors."""
    comm_cfg = comm if isinstance(comm, CommConfig) else CommConfig(
        strategy=comm, bucket_mb=bucket_mb, wire_dtype=comm_dtype)
    if comm_cfg.wire_dtype not in ("bf16", "f32"):
        raise ValueError(comm_cfg.wire_dtype)
    if comm_cfg.strategy != "xla":
        loss_fn = make_loss_fn(model, smoothing=smoothing)
        if model.cfg.moe is not None:
            raise explicit_moe(f"comm={comm_cfg.strategy!r}",
                               model.cfg.arch_id)
        return _guarded(_explicit_step(model, opt_cfg, schedule, loss_fn,
                                       comm_cfg, mesh, grad_accum, tracer,
                                       profile_batch, smoothing), guard)
    if comm_cfg.sharding != "replicated":
        raise ValueError(
            f"sharding={comm_cfg.sharding!r} needs an explicit-DP schedule "
            f"(comm='psum', 'ring', ...), not comm='xla'")
    tp, dp, split = _xla_mesh(model, mesh)
    loss_fn = make_loss_fn(model, smoothing=smoothing, mesh=mesh)
    bf16 = comm_cfg.wire_dtype == "bf16"

    def grads_of(p_in, batch, bn_state, lfn):
        flat = tree_flatten(p_in)
        total, (metrics, new_bn) = lfn(p_in, batch, bn_state)
        grads = torch.autograd.grad(total, [leaf for _, leaf in flat])
        return tree_unflatten([p for p, _ in flat], grads), metrics, new_bn

    def train_step(state: TrainState, batch, guard_in=None):
        lfn = _loss_for(loss_fn, guard_in)
        p_in = cast_to_compute(state.params) if bf16 else state.params
        p_in = tree_map(lambda p: p.detach().requires_grad_(), p_in)
        if grad_accum == 1:
            grads, metrics, new_bn = grads_of(p_in, batch, state.bn_state,
                                              lfn)
        else:
            # the paper's 81,920 global batch on fewer chips: microbatches
            micro = {k: v.reshape(grad_accum, v.shape[0] // grad_accum,
                                  *v.shape[1:]) for k, v in batch.items()}
            grads, new_bn, ms = None, state.bn_state, []
            for i in range(grad_accum):
                g, m, new_bn = grads_of(
                    p_in, {k: v[i] for k, v in micro.items()}, new_bn, lfn)
                g = tree_map(lambda x: x.float(), g)
                grads = g if grads is None else tree_map(torch.add, grads, g)
                ms.append(m)
            grads = tree_map(lambda g: g / grad_accum, grads)
            metrics = {k: torch.stack([m[k] for m in ms]).mean()
                       for k in ms[0]}
        # the compute copy is spent: K1's norms pack the masters and the
        # gradients, and an update not donated allocates new masters and
        # momentum beside the old, so its bytes matter at the peak
        del p_in
        if dp:
            # the whole batch's gradient: the data ranks' mean, in f32
            grads = prim.pmean_tree(tree_map(lambda g: g.float(), grads), dp)
            metrics = prim.pmean_tree(metrics, dp)
        lr = _lr(schedule, state, guard_in)
        if guard_in is not None:
            ok, metrics = guard_lib.check(metrics, grads, model_axis=tp,
                                          split=split)
            if not ok:
                return state, dict(metrics, lr=lr)
        params, mom = lars.update(state.params, grads, state.mom, lr,
                                  opt_cfg, model_axis=tp, split=split,
                                  inplace=donate)
        metrics = dict(metrics, lr=lr)
        return TrainState(state.step + 1, params, mom, new_bn), metrics

    train_step.comm = "xla"
    train_step.mesh = mesh
    train_step.sharding = "replicated"
    # what a checkpoint gathers and cuts the split leaves by
    train_step.param_pd = model.param_pd
    return _guarded(train_step, guard)


def explicit_moe(what: str, arch: str) -> NotImplementedError:
    """The error of an explicit data-parallel schedule with a MoE config:
    the reference's explicit step runs the model without a mesh, and its
    MoE layer runs only inside ``shard_map`` over one, so that step cannot
    run it there and the port has nothing to port (no ROADMAP item)."""
    return NotImplementedError(
        f"{what} with {arch}: the reference's explicit data-parallel step "
        f"runs the model without a mesh, and its MoE layer runs only over "
        f"one, so no such step exists to port; train the MoE family with "
        f"comm='xla'")


def _xla_mesh(model, mesh):
    """The ``comm='xla'`` step's view of ``mesh``: (the model axis or
    None, the data axes a gradient is meaned over, the paths of the leaves
    split over the model axis). What the port does not place yet is
    refused by ``transformer.tp_axis``, naming its ROADMAP item (``fsdp``
    over data ranks: item 6.3)."""
    from repro_torch.models import transformer
    if mesh is None or mesh.size == 1:
        return None, (), frozenset()
    cfg = model.cfg
    # the conv family splits no leaf: every leaf replicated over 'model',
    # its batch over the data axes alone, as GSPMD places it
    tp = None if cfg.family == "conv" else transformer.tp_axis(cfg, mesh)
    dp = tuple(a for a in mesh.axes if a.name != "model" and a.size > 1)
    split = frozenset(path for path, pd in tree_flatten(model.param_pd)
                      if local_slice(pd, tp)[0] is not None)
    return tp, dp, split


def _loss_for(loss_fn, guard_in):
    """The loss a guarded step differentiates (scaled by ``loss_scale``:
    the spike fault), or ``loss_fn`` itself."""
    if guard_in is None:
        return loss_fn
    return guard_lib.scale_loss(loss_fn, float(guard_in["loss_scale"]))


def _lr(schedule, state, guard_in):
    lr = schedule(state.step)
    if guard_in is not None:
        lr = lr * torch.tensor(guard_in["lr_scale"], dtype=torch.float32)
    return lr


def _guarded(step, guard: bool):
    """``step`` as the caller asked for it: ``guard=True`` takes a
    ``guard_in`` argument it must be given; the introspection attributes
    are carried over."""
    if guard:
        def train_step(state: TrainState, batch, guard_in):
            return step(state, batch, guard_in)
    else:
        def train_step(state: TrainState, batch):
            return step(state, batch)
    train_step.__dict__.update(step.__dict__)
    train_step.guarded = guard
    return train_step


def _explicit_step(model, opt_cfg, schedule, loss_fn, comm_cfg, mesh,
                   grad_accum, tracer, profile_batch, smoothing):
    """The explicit data-parallel step (paper §III-C): replicated or one of
    the sharded rungs, over ``mesh``'s axes (every axis is data
    parallel). Takes ``guard_in`` (None: unguarded)."""
    from repro_torch.comm import get_schedule, plan_for
    from repro_torch.comm.schedules import shard_axis
    comm = comm_cfg.strategy
    if comm != "naive":
        get_schedule(comm)                # unknown names raise here
    if mesh is None:
        raise ValueError(f"comm={comm!r} needs a mesh "
                         f"(repro_torch.launch.mesh.make_mesh)")
    if grad_accum != 1:
        raise ValueError("grad_accum is a comm='xla' option")
    # 'naive' has no bucket plan to shard against: replicated, as in the
    # reference
    sharding = comm_cfg.sharding if comm != "naive" else "replicated"
    shard_update = sharding != "replicated"
    if shard_update and (opt_cfg.kind not in ("lars", "sgdm")
                         or opt_cfg.nesterov):
        raise ValueError(f"sharding={sharding!r} supports lars/sgdm "
                         f"without nesterov, not {opt_cfg.kind!r}")
    axes = mesh.axes
    # shard over the innermost non-trivial axis, as the scatter schedules
    sh_axis = shard_axis(axes)
    n_shards = sh_axis.size
    gather_mode = comm_cfg.gather if shard_update else "at_end"
    # the step-start prefetch is a zero1 notion; zero3's 'ahead' keeps the
    # forward's gathers for the backward
    gather_ahead = gather_mode == "ahead" and sharding == "zero1"
    overlap = comm_cfg.overlap and comm != "naive"
    wire = torch.bfloat16 if comm_cfg.wire_dtype == "bf16" else torch.float32
    wire_bytes = 2 if wire == torch.bfloat16 else 4
    bucket_mb, tuned, profile = comm_cfg.bucket_mb, None, None
    if bucket_mb == "auto" and comm == "naive":
        bucket_mb = 4.0                # per-tensor all-reduces: no plan used
    elif bucket_mb == "auto":
        from repro_torch.comm.autotune import autotune
        if comm_cfg.backward_profile == "measured" \
                and profile_batch is not None:
            profile = _measure_profile(model, profile_batch,
                                       smoothing=smoothing, mesh=mesh)
        tuned = autotune(model.param_pd, schedule=comm,
                         axes=mesh.axis_names,
                         sizes=tuple(a.size for a in axes),
                         dtype_bytes=wire_bytes, family=model.cfg.family,
                         profile=profile, sharding=sharding,
                         gather=gather_mode, param_dtype_bytes=wire_bytes)
        bucket_mb = tuned.bucket_mb
    plan = bucketing.make_plan(model.param_pd, bucket_mb=bucket_mb,
                               dtype_bytes=wire_bytes)
    collective = dict(strategy=comm, axes=axes, comm_dtype=wire,
                      use_kernel=comm_cfg.use_kernel, tracer=tracer)
    paths = plan.paths

    def stamp(name, phase, deps):
        mark(tracer, name, phase, deps, cat="compute")

    def differentiate(lfn, wrt, *args):
        """``lfn(*args)`` and its gradient with respect to ``wrt``, with
        the forward and backward spans stamped between them."""
        stamp("forward", "B", wrt[:1])
        total, (metrics, new_bn) = lfn(*args)
        stamp("forward", "E", [total])
        stamp("backward", "B", [total])
        grads = torch.autograd.grad(total, wrt)
        stamp("backward", "E", grads[:1])
        return grads, metrics, new_bn

    def grads_of(params, batch, bn_state, lfn):
        """Local (unreduced) fp32 gradients, for the post-backward path."""
        leaves = [params_leaf.detach().requires_grad_()
                  for _, params_leaf in tree_flatten(params)]
        grads, metrics, new_bn = differentiate(
            lfn, leaves, tree_unflatten(paths, leaves), batch, bn_state)
        return tree_unflatten(paths, grads), metrics, new_bn

    def scatter(params_of, batch, bn_state, lfn, remat=False):
        """The gradient's reduce-scatter, of the loss at the params
        ``params_of()`` builds: inside the backward (the reduced-mean fp32
        shards come back as the gradients of zero sinks; the params are
        not differentiated, so no full reduced gradient exists) or after
        it. ``remat`` checkpoints the loss with ``params_of`` inside it,
        so the backward builds the params again. Returns (g_shards,
        metrics, new_bn)."""
        if not overlap:
            grads, metrics, new_bn = grads_of(params_of(), batch, bn_state,
                                              lfn)
            return (ddp.reduce_scatter_grads(grads, plan=plan, **collective),
                    metrics, new_bn)

        def loss(sinks, b, bn):
            return lfn(ddp.wrap_params_for_overlap(
                params_of(), plan, shard_sinks=sinks, **collective), b, bn)

        sinks = ddp.make_shard_sinks(plan, n_shards, device=mesh.device)
        fn = (lambda *a: checkpoint(loss, *a, use_reentrant=False)) \
            if remat else loss
        g_shards, metrics, new_bn = differentiate(fn, sinks, sinks, batch,
                                                  bn_state)
        return list(g_shards), metrics, new_bn

    def gate(state, metrics, grads, lr, guard_in, sharded):
        """The guard's decision, before any write: (metrics, the skipped
        step's result or None to go on)."""
        if guard_in is None:
            return metrics, None
        ok, metrics = guard_lib.check(metrics, grads,
                                      axes=(sh_axis,) if sharded else None)
        return metrics, None if ok else (state, dict(metrics, lr=lr))

    def finish(state, metrics, new_bn, guard_in):
        new_bn = prim.pmean_tree(new_bn, axes) if new_bn is not None \
            else None
        return (prim.pmean_tree(metrics, axes), new_bn,
                _lr(schedule, state, guard_in))

    def update(state, p_shards, g_shards, lr):
        stamp("update", "B", g_shards[:1])
        out = lars.sharded_update_from_shards(
            list(p_shards), g_shards, list(state.mom), lr, opt_cfg, plan,
            shard_axis=sh_axis, n_shards=n_shards,
            update_kernel=comm_cfg.update_kernel)
        stamp("update", "E", out[0][:1])
        return out

    def replicated_step(state: TrainState, batch, guard_in=None):
        lfn = _loss_for(loss_fn, guard_in)
        if overlap:
            leaves = [x.detach().requires_grad_()
                      for _, x in tree_flatten(state.params)]
            p = ddp.wrap_params_for_overlap(tree_unflatten(paths, leaves),
                                            plan, **collective)
            grads, metrics, new_bn = differentiate(lfn, leaves, p, batch,
                                                   state.bn_state)
            grads = tree_unflatten(paths, grads)
        else:
            grads, metrics, new_bn = grads_of(state.params, batch,
                                              state.bn_state, lfn)
            grads = ddp.allreduce_grads(grads, plan=plan, **collective)
        metrics, new_bn, lr = finish(state, metrics, new_bn, guard_in)
        metrics, skip = gate(state, metrics, grads, lr, guard_in, False)
        if skip is not None:
            return skip
        first = tree_flatten(grads)[:1]
        stamp("update", "B", [g for _, g in first])
        params, mom = lars.update(state.params, grads, state.mom, lr,
                                  opt_cfg)
        stamp("update", "E", [g for _, g in first])
        return (TrainState(state.step + 1, params, mom, new_bn),
                dict(metrics, lr=lr))

    def need_shards(state):
        if state.shards is None:
            raise ValueError(
                f"sharding={sharding!r} needs the persistent-shard state: "
                f"init_state(..., **train.state.sharded_state_kwargs(step))")

    def zero1_step(state: TrainState, batch, guard_in=None):
        need_shards(state)
        # gather-ahead: this step's forward params from the master shards
        # the previous step updated; otherwise the copy gathered at the
        # end of the previous step
        params = (ddp.gather_ahead_params(state.shards, plan,
                                          shard_axis=sh_axis,
                                          wire_dtype=wire, tracer=tracer)
                  if gather_ahead else state.params)
        g_shards, metrics, new_bn = scatter(lambda: params, batch,
                                            state.bn_state,
                                            _loss_for(loss_fn, guard_in))
        metrics, new_bn, lr = finish(state, metrics, new_bn, guard_in)
        metrics, skip = gate(state, metrics, g_shards, lr, guard_in, True)
        if skip is not None:
            return skip
        p_shards, m_shards = update(state, state.shards, g_shards, lr)
        new_params = (params if gather_ahead else
                      ddp.all_gather_params(p_shards, plan,
                                            shard_axis=sh_axis,
                                            wire_dtype=wire, tracer=tracer))
        return (TrainState(state.step + 1, new_params, m_shards, new_bn,
                           p_shards), dict(metrics, lr=lr))

    def zero2_step(state: TrainState, batch, guard_in=None):
        # the replicated fp32 params ARE the masters (no shards, no
        # start-of-step gather); gradients and momentum shard as in zero1
        if state.params is None or state.shards is not None:
            raise ValueError(
                "sharding='zero2' keeps the replicated params as masters "
                "with sharded momentum and no shards: init_state(..., "
                "**train.state.sharded_state_kwargs(step))")
        g_shards, metrics, new_bn = scatter(lambda: state.params, batch,
                                            state.bn_state,
                                            _loss_for(loss_fn, guard_in))
        metrics, new_bn, lr = finish(state, metrics, new_bn, guard_in)
        metrics, skip = gate(state, metrics, g_shards, lr, guard_in, True)
        if skip is not None:
            return skip
        # transient master shards: this rank's ring chunk of each packed
        # bucket (the chunk its reduce-scatter left here)
        k = prim.shard_index(sh_axis)
        p_shards = []
        for buf in bucketing.pack(state.params, plan, dtype=torch.float32):
            padded = bucketing.pad_to_shards(buf, n_shards)
            c = padded.shape[0] // n_shards
            p_shards.append(padded[k * c:(k + 1) * c])
        p_shards, m_shards = update(state, p_shards, g_shards, lr)
        # fp32 on the wire: this gather writes the masters back
        new_params = ddp.all_gather_params(p_shards, plan,
                                           shard_axis=sh_axis,
                                           wire_dtype=torch.float32,
                                           tracer=tracer)
        return (TrainState(state.step + 1, new_params, m_shards, new_bn),
                dict(metrics, lr=lr))

    def zero3_step(state: TrainState, batch, guard_in=None):
        # no params anywhere: the forward rebuilds them from the master
        # shards group by group; with gather='per_group' the gathered loss
        # is checkpointed, so the backward gathers again instead of
        # keeping the forward's copies ('ahead' keeps them). Post-backward
        # the gathered tree is a step transient (per_group then keeps it,
        # as in the reference). Where the wire carries the compute dtype
        # the tree is gathered in it: the fp32 copy the reference unpacks
        # would only be cast back, value for value, and would double the
        # gathered bytes (zamba2-7b: 27 GB)
        need_shards(state)
        dt = wire if wire == compute_dtype() else torch.float32
        g_shards, metrics, new_bn = scatter(
            lambda: ddp.jit_gather_params(state.shards, plan,
                                          shard_axis=sh_axis,
                                          wire_dtype=wire, dtype=dt,
                                          tracer=tracer),
            batch, state.bn_state, _loss_for(loss_fn, guard_in),
            remat=gather_mode == "per_group")
        metrics, new_bn, lr = finish(state, metrics, new_bn, guard_in)
        metrics, skip = gate(state, metrics, g_shards, lr, guard_in, True)
        if skip is not None:
            return skip
        p_shards, m_shards = update(state, state.shards, g_shards, lr)
        return (TrainState(state.step + 1, None, m_shards, new_bn,
                           p_shards), dict(metrics, lr=lr))

    train_step = {"replicated": replicated_step, "zero1": zero1_step,
                  "zero2": zero2_step, "zero3": zero3_step}[sharding]
    # introspection: the resolved comm plan, as the reference's step has it
    train_step.comm = comm
    train_step.mesh = mesh
    train_step.bucket_plan = plan
    train_step.bucket_mb = bucket_mb
    train_step.tuned = tuned
    train_step.backward_profile = profile
    train_step.overlap = overlap
    train_step.sharding = sharding
    train_step.gather = gather_mode
    train_step.shard_update = shard_update
    train_step.gather_ahead = gather_ahead
    train_step.shard_axis = sh_axis.name
    train_step.n_shards = n_shards
    # the serializable CommPlan, saved beside every checkpoint
    train_step.comm_plan = plan_for(
        comm_cfg, mesh, model.param_pd, resolved_bucket_mb=bucket_mb,
        strategy=comm, overlap=overlap, sharding=sharding, gather=gather_mode,
        n_shards=n_shards if shard_update else 1)
    return train_step


def _measure_profile(model, batch, *, smoothing: float, mesh):
    """The profiled warm-up step of ``backward_profile='measured'``: this
    rank's loss at freshly initialised params (seed 0), differentiated on
    its own card with probing identities at the bucket-group boundaries
    (``comm.autotune.measure_backward_profile``: CUDA events on the card).
    ``batch`` is this rank's. Falls back to the FLOPs model (None) if the
    capture fails, with a ``backward_profile_fallback`` event, as the
    reference does. Every rank then takes rank 0's profile, so that all
    autotune the same bucket plan."""
    import torch.distributed as dist

    from repro_torch.comm.autotune import measure_backward_profile
    from repro_torch.core import pinit
    from repro_torch.obs import metrics as obs_metrics
    where = "repro_torch/train/step.py"
    try:
        dev = mesh.device
        params = pinit.materialize(model.param_pd, 0, dev)
        bn = (pinit.materialize(model.bn_state_pd, 0, dev)
              if model.bn_state_pd is not None else None)
        local_loss = make_loss_fn(model, smoothing=smoothing)
        prof = measure_backward_profile(
            lambda p: local_loss(p, batch, bn)[0], params)
        del params, bn
        obs_metrics.event(
            "backward_profile_measured",
            {"groups": len(prof.cum_elems),
             "total_ms": round(prof.total_s * 1e3, 1),
             "forward_ms": (None if prof.t_forward_s is None
                            else round(prof.t_forward_s * 1e3, 1))},
            where=where)
    except Exception as e:  # noqa: BLE001 (the profile is best-effort)
        obs_metrics.event(
            "backward_profile_fallback",
            f"{type(e).__name__}: {e}; falling back to the FLOPs model",
            where=where)
        prof = None
    if dist.is_initialized() and dist.get_world_size() > 1:
        box = [prof]
        dist.broadcast_object_list(box, src=0)
        prof = box[0]
    return prof


def make_eval_step(model, mesh=None):
    """eval_step(params, batch, bn_state) -> {'loss', 'acc'}, no
    smoothing: the conv family with the running BN statistics; the LMs
    through ``_lm_loss`` (K4 on the card) with ``acc`` 0, as the reference
    returns it. ``mesh``: the LM over its model axis, on the shard tree
    the ``comm='xla'`` step's state holds (each rank its own rows)."""
    cfg = model.cfg

    @torch.no_grad()
    def eval_step(params, batch, bn_state=None):
        if cfg.family != "conv":
            (logits, _), _ = model.forward_train(params, batch, mesh=mesh)
            loss, _ = _lm_loss(logits, batch["labels"], smoothing=0.0)
            return {"loss": loss,
                    "acc": torch.zeros((), device=loss.device)}
        logits, _ = resnet_forward(cast_to_compute(params), bn_state, cfg,
                                   batch["images"], train=False)
        loss, _ = smoothed_xent(logits, batch["labels"], smoothing=0.0)
        return {"loss": loss, "acc": top1_accuracy(logits, batch["labels"])}

    return eval_step
