"""Collective-schedule subsystem (paper §III-C): gradient all-reduce
decomposed into schedules over the mesh's data-parallel axes, each with a
reduce-scatter-terminal form for the sharded rungs. A port of
``repro.comm``: every schedule of the reference (psum, ring, hierarchical,
2d_torus, dbtree, and the ``bucketed`` alias), with the ring-step fold
kernel K3 (``comm.ring_kernel``), and the serialisable ``CommPlan``
(``comm.plan``), each schedule paired with an alpha-beta cost model
(``comm.cost``, the card's constants from ``launch/hw.py``) that
``comm.autotune`` searches bucket sizes against.

``plan_for(config, mesh, tree)`` turns a ``CommConfig`` (or a run config
carrying one at ``.comm``), a mesh and a parameter (descriptor) tree into
a committed ``CommPlan``: it resolves the shard axis, autotunes
``bucket_mb='auto'`` (searching the schedules too when ``strategy='auto'``)
and commits the packing layout, the same assembly
``train.step.make_train_step`` performs, without building a step.
"""
from typing import Optional, Sequence, Union

from repro_torch.comm.autotune import (  # noqa: F401
    CANDIDATES_MB, BackwardProfile, OverlapSim, TunedPlan, best_plan,
    simulate)
from repro_torch.comm.cost import (  # noqa: F401
    CostBreakdown, Link, lars_update_time_s, param_memory,
    param_memory_reduction, predict, predict_all_gather,
    predict_reduce_scatter, predict_table)
from repro_torch.comm.plan import CommPlan, CommPlanError  # noqa: F401
from repro_torch.comm.registry import (  # noqa: F401
    available, get_reduce_scatter, get_schedule)


def _mesh_axes(mesh):
    """The mesh's ``launch.mesh.Axis`` tuple, from a ``Mesh`` or an
    ``(axes, sizes)`` pair (then with no ranks or groups)."""
    if isinstance(mesh, (tuple, list)) and len(mesh) == 2:
        from repro_torch.launch.mesh import Axis
        axes, sizes = mesh
        return tuple(Axis(a, int(s), 0, ()) for a, s in zip(axes, sizes))
    return tuple(mesh.axes)


def plan_for(config, mesh, tree, *, family: Optional[str] = None,
             profile: Optional[BackwardProfile] = None,
             t_backward_s: Optional[float] = None,
             schedules: Optional[Sequence[str]] = None,
             resolved_bucket_mb: Optional[Union[float, str]] = None,
             strategy: Optional[str] = None, overlap: Optional[bool] = None,
             sharding: Optional[str] = None, gather: Optional[str] = None,
             n_shards: Optional[int] = None, links=None,
             hw=None) -> CommPlan:
    """Resolve a ``CommConfig`` against a mesh (a ``launch.mesh.Mesh`` or
    an ``(axes, sizes)`` pair) and a parameter tree into a ``CommPlan``.
    ``bucket_mb='auto'`` autotunes against the alpha-beta timeline
    (``family``/``profile``/``t_backward_s`` refine the backward model,
    ``links``/``hw`` the constants); ``strategy='auto'`` also searches
    every costed schedule (restrict with ``schedules``). The keyword
    overrides record *effective* values where a caller
    (``make_train_step``) has already downgraded them;
    ``resolved_bucket_mb`` skips the re-autotune when the caller already
    resolved 'auto'."""
    from repro_torch.comm import autotune as autotune_mod
    from repro_torch.comm import plan as plan_mod
    from repro_torch.comm.schedules import shard_axis
    from repro_torch.core import bucketing

    comm_cfg = getattr(config, "comm", config)
    axes = _mesh_axes(mesh)
    names = tuple(a.name for a in axes)
    sizes = tuple(a.size for a in axes)
    eff_strategy = strategy or comm_cfg.strategy
    eff_sharding = sharding if sharding is not None else comm_cfg.sharding
    eff_gather = gather if gather is not None else comm_cfg.gather
    wire_bytes = 2 if comm_cfg.wire_dtype == "bf16" else 4
    sh_axis = shard_axis(axes)
    bucket_mb = (comm_cfg.bucket_mb if resolved_bucket_mb is None
                 else resolved_bucket_mb)
    if bucket_mb == "auto":
        kw = dict(axes=names, sizes=sizes, dtype_bytes=wire_bytes,
                  t_backward_s=t_backward_s, family=family, profile=profile,
                  sharding=eff_sharding, gather=eff_gather,
                  param_dtype_bytes=wire_bytes, links=links, hw=hw)
        if eff_strategy in ("auto", "naive"):
            tuned = autotune_mod.best_plan(tree, schedules=schedules, **kw)
            if eff_strategy == "auto":
                eff_strategy = tuned.schedule
        else:
            tuned = autotune_mod.autotune(tree, schedule=eff_strategy, **kw)
        bucket_mb = tuned.bucket_mb
    bp = bucketing.make_plan(tree, bucket_mb=bucket_mb,
                             dtype_bytes=wire_bytes)
    if n_shards is None:
        n_shards = sh_axis.size if eff_sharding != "replicated" else 1
    return plan_mod.make(
        comm_cfg, bp, resolved_bucket_mb=bucket_mb, mesh_axes=names,
        mesh_sizes=sizes, shard_axis=sh_axis.name, n_shards=n_shards,
        strategy=eff_strategy, overlap=overlap, sharding=eff_sharding,
        gather=eff_gather)
