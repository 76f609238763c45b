"""When the in-backward collectives start: each bucket group's identity
(``core.ddp``) runs as soon as its group's cotangents exist, not after the
whole backward.

Autograd runs the ready node of the highest sequence number first. An
identity made before the forward is the oldest node of the graph, so it
ran last; ``ddp._wrap_param_groups`` now makes each group's identity where
the forward first reads one of the group's leaves (a ``tree.LazyTree``),
and ``cast_to_compute`` keeps such a tree lazy, so the bf16 cast of a leaf
follows its identity at that same moment.

Held here on the CPU: a three-layer chain, f32 and with the bf16 cast;
and the reduced ResNet-50 through the replicated overlap wrap, the zero1
sink wrap and the measured-profile probe, with a hook on the stem's output
(the max-pool's) recording when the stem's gradient arrives. ResNet's
plan packs in reverse flatten order, and ``stem`` is the last key in
flatten order, so group 0 holds the stem's own leaves (and the last
group the head's): group 0 can only run after the stem's backward. Every
other group must run before the stem's gradient arrives, and the groups
run b1, b2, ..., then b0.
"""
import pytest
import torch

from repro_torch.comm import autotune
from repro_torch.configs import get_config
from repro_torch.core import bucketing, ddp, pinit
from repro_torch.core.precision import cast_to_compute
from repro_torch.data.synthetic import prototype_imagenet
from repro_torch.launch.mesh import Axis
from repro_torch.models import resnet as rn
from repro_torch.models.registry import build_model
from repro_torch.train.step import make_loss_fn
from repro_torch.tree import tree_flatten, tree_unflatten

pytestmark = pytest.mark.tier1

ONE_RANK = Axis("data", 1, 0, (0,), None)


class _Names:
    """A tracer that keeps only the order of the collectives' begins."""

    def __init__(self, events):
        self.events = events

    def stamp(self, name, phase, device=None, *, cat="comm", **args):
        if phase == "B":
            self.events.append(name)


def _chain_order(eager: bool, bf16: bool):
    """Three layers ``x <- tanh(x @ w_k)``, each weight its own bucket
    group (group 0 is w3: reverse flatten order). Returns the order in
    which each layer's output gradient arrives (``L<k>``) and each group's
    identity runs (``ar[b<i>]``)."""
    torch.manual_seed(0)
    tree = {f"w{k}": (0.1 * torch.randn(32, 32)).requires_grad_()
            for k in (1, 2, 3)}
    plan = bucketing.make_plan(tree, bucket_mb=32 * 32 * 2 / 2 ** 20)
    assert [[s.path for s in g] for g in plan.groups] == [["w3"], ["w2"],
                                                          ["w1"]]
    events = []
    p = ddp.wrap_params_for_overlap(tree, plan, strategy="psum",
                                    axes=(ONE_RANK,), tracer=_Names(events))
    if eager:
        # every identity made before the forward: the wrap's old form
        p = tree_unflatten(*zip(*tree_flatten(p)))
    if bf16:
        p = cast_to_compute(p)
    x = torch.randn(4, 32, dtype=torch.bfloat16 if bf16 else torch.float32)
    for k in (1, 2, 3):
        x = torch.tanh(x @ p[f"w{k}"])
        x.register_hook(lambda g, k=k: events.append(f"L{k}"))
    grads = torch.autograd.grad(x.float().square().sum(), list(
        tree.values()))
    assert all(g.dtype == torch.float32 for g in grads)
    return events


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16_cast"])
def test_chain_identity_runs_when_its_layer_is_done(bf16):
    assert _chain_order(eager=False, bf16=bf16) == [
        "L3", "ar[b0]", "L2", "ar[b1]", "L1", "ar[b2]"]


def test_chain_identities_made_before_the_forward_run_last():
    """The order the wrap gave before: the identities, made before the
    forward, wait for the whole backward."""
    assert _chain_order(eager=True, bf16=False) == [
        "L3", "L2", "L1", "ar[b0]", "ar[b1]", "ar[b2]"]


def test_chain_gradients_are_bit_equal_either_way():
    """Only the moment each identity runs changes, not what it returns."""
    def grads(eager):
        torch.manual_seed(0)
        tree = {f"w{k}": torch.randn(32, 32).requires_grad_()
                for k in (1, 2, 3)}
        plan = bucketing.make_plan(tree, bucket_mb=32 * 32 * 2 / 2 ** 20)
        p = ddp.wrap_params_for_overlap(tree, plan, strategy="psum",
                                        axes=(ONE_RANK,))
        if eager:
            p = tree_unflatten(*zip(*tree_flatten(p)))
        p = cast_to_compute(p)
        x = torch.randn(4, 32, dtype=torch.bfloat16)
        for k in (1, 2, 3):
            x = torch.tanh(x @ p[f"w{k}"])
        return torch.autograd.grad(x.float().sum(), list(tree.values()))

    assert all(torch.equal(a, b) for a, b in zip(grads(False), grads(True)))


_RESNET = {}


def _resnet():
    """Reduced ResNet-50, its params, BN state, a batch of 2 and its
    0.25 MB plan (15 groups), built once."""
    if not _RESNET:
        torch.manual_seed(0)
        cfg = get_config("resnet50").reduced()
        model = build_model(cfg)
        _RESNET.update(
            model=model, plan=bucketing.make_plan(model.param_pd,
                                                  bucket_mb=0.25),
            params=pinit.materialize(model.param_pd, 0, "cpu"),
            bn=pinit.materialize(model.bn_state_pd, 0, "cpu"),
            batch=prototype_imagenet(cfg, batch=2, step=0, device="cpu"))
    return _RESNET


def _stem_hooked(monkeypatch, events):
    """Record 'stem' when the gradient of the stem's output (the
    max-pool's) arrives."""
    pool = rn._maxpool

    def hooked(x):
        y = pool(x)
        if y.requires_grad:
            y.register_hook(lambda g: events.append("stem"))
        return y

    monkeypatch.setattr(rn, "_maxpool", hooked)


def _run(kind, monkeypatch):
    r = _resnet()
    model, plan, params, bn, batch = (r["model"], r["plan"], r["params"],
                                      r["bn"], r["batch"])
    loss = make_loss_fn(model)
    events = []
    _stem_hooked(monkeypatch, events)
    kw = dict(strategy="psum", axes=(ONE_RANK,), tracer=_Names(events))
    if kind == "overlap":
        flat = tree_flatten(params)
        leaves = [x.detach().requires_grad_() for _, x in flat]
        p = ddp.wrap_params_for_overlap(
            tree_unflatten([k for k, _ in flat], leaves), plan, **kw)
        torch.autograd.grad(loss(p, batch, bn)[0], leaves)
    elif kind == "sink":
        sinks = ddp.make_shard_sinks(plan, 1)
        p = ddp.wrap_params_for_overlap(params, plan, shard_sinks=sinks,
                                        **kw)
        torch.autograd.grad(loss(p, batch, bn)[0], sinks)
    else:
        wrap = ddp.wrap_params_for_probe

        def recording(p, plan, probe):
            def rec(i):
                if i >= 0:
                    events.append(f"probe[b{i}]")
                probe(i)
            return wrap(p, plan, rec)

        monkeypatch.setattr(ddp, "wrap_params_for_probe", recording)
        prof = autotune.measure_backward_profile(
            lambda q: loss(q, batch, bn)[0], params, bucket_mb=0.25)
        assert len(prof.cum_time_s) == plan.n_buckets
        # the profiled run is the second (after one warm-up)
        events = events[len(events) // 2:]
    return plan, events


@pytest.mark.parametrize("kind", ["overlap", "sink", "probe"])
def test_resnet_groups_run_before_the_stems_gradient(kind, monkeypatch):
    plan, events = _run(kind, monkeypatch)
    n = plan.n_buckets
    holds_stem = {gi for gi, g in enumerate(plan.groups)
                  if any(s.path.startswith("stem/") for s in g)}
    assert n == 15 and holds_stem == {0}
    prefix = {"overlap": "ar", "sink": "rs", "probe": "probe"}[kind]
    groups = [e for e in events if e != "stem"]
    assert len(groups) == n and events.count("stem") == 1
    before = events[:events.index("stem")]
    # every group but the stem's runs before the stem's gradient arrives
    assert sorted(before) == sorted(f"{prefix}[b{i}]" for i in range(1, n))
    # ... in group order, then group 0 once the stem's backward is done
    assert groups == [f"{prefix}[b{i}]" for i in (*range(1, n), 0)]
