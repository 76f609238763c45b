"""Collective-schedule subsystem (paper §III-C): gradient all-reduce
decomposed into schedules over the mesh's data-parallel axes, each with a
reduce-scatter-terminal form for the sharded rungs. A port of
``repro.comm``: every schedule of the reference (psum, ring, hierarchical,
2d_torus, dbtree, and the ``bucketed`` alias), with the ring-step fold
kernel K3 (``comm.ring_kernel``), and the serialisable ``CommPlan``
(``comm.plan``). The cost model and the autotuner are ROADMAP §1 item 7b.

``plan_for(config, mesh, tree)`` turns a ``CommConfig`` (or a run config
carrying one at ``.comm``), a mesh and a parameter (descriptor) tree into
a committed ``CommPlan``, the same assembly ``train.step.make_train_step``
performs, without building a step.
"""
from typing import Optional

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


def plan_for(config, mesh, tree, *, strategy: Optional[str] = None,
             overlap: Optional[bool] = None, sharding: Optional[str] = None,
             gather: Optional[str] = None,
             n_shards: Optional[int] = None) -> CommPlan:
    """Resolve a ``CommConfig`` against a mesh (a ``launch.mesh.Mesh`` or
    an ``(axes, sizes)`` pair) and a parameter tree into a ``CommPlan``.
    The keyword overrides record *effective* values where a caller
    (``make_train_step``) has already downgraded them. Explicit bucket
    sizes only: ``bucket_mb='auto'`` is the autotuner (item 7b)."""
    from repro_torch.comm import plan as plan_mod
    from repro_torch.comm.schedules import shard_axis
    from repro_torch.core import bucketing

    comm_cfg = getattr(config, "comm", config)
    if comm_cfg.bucket_mb == "auto":
        raise plan_mod._autotune_not_ported("plan_for(bucket_mb='auto')")
    axes = _mesh_axes(mesh)
    eff_sharding = sharding if sharding is not None else comm_cfg.sharding
    sh_axis = shard_axis(axes)
    bp = bucketing.make_plan(
        tree, bucket_mb=comm_cfg.bucket_mb,
        dtype_bytes=2 if comm_cfg.wire_dtype == "bf16" else 4)
    if n_shards is None:
        n_shards = sh_axis.size if eff_sharding != "replicated" else 1
    return plan_mod.make(
        comm_cfg, bp, resolved_bucket_mb=comm_cfg.bucket_mb,
        mesh_axes=tuple(a.name for a in axes),
        mesh_sizes=tuple(a.size for a in axes), shard_axis=sh_axis.name,
        n_shards=n_shards, strategy=strategy, overlap=overlap,
        sharding=eff_sharding, gather=gather)
