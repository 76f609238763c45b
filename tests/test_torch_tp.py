"""The model axis (ROADMAP §1 item 6.2) for the dense decoder: the reduced
qwen1.5-0.5b (tied: its embedding splits the vocabulary) and qwen1.5-32b
(untied, QKV bias: its embedding splits d, its head the vocabulary) over a
(data 2, model 2) mesh of four gloo ranks (``torch_ranks.py lm_tp``),
against the JAX package's GSPMD program on a (2, 2) Auto-axis mesh of four
host devices (``torch_reference.py tp_cases``: one subprocess, its params
placed by their specs, its flash path in ``shard_map`` under the shim).

Held against the reference, with the worst figures measured here: the
forward's, the prefill's and one decode step's logits and the caches
(gathered over both axes), the greedy tokens (``check_greedy_tokens`` on
each rank's rows; in bf16 at the serving margin), and two ``comm='xla'``
steps from the reference's own inputs (loss, masters, momentum).

- f32 (the port under ``precision.f32_compute``, the reference under
  ``_jax_f32_compute``, the steps differentiating the f32 masters):
  logits 1.21e-6 of their max, caches 9.4e-7; steps: loss 1.5e-7
  relative, masters 9.0e-5 of their tensor's largest update (a master's
  own rounding), momentum 1.7e-6 of its largest element. Bounds 1e-5
  (logits, caches), 1e-6 (loss), 5e-4 (masters), 1e-5 (momentum).
- bf16: logits 7.8e-3 of their max (the flash path; 5.8e-3 without),
  caches 3.8e-3; steps: loss 5.8e-5, masters and momentum 3.4e-2. Bounds:
  the serving bound 3e-2 (logits, caches) and the LM step's 4e-4 and
  5e-2 (``test_torch_dp_frames.py``'s).

Within the port, in f32, the reduced qwen1.5-0.5b as it is and with
``qk_norm`` and a 16-token sliding window, model 2 against the full tree
with no mesh: logits 1.32e-6 of their max (bound 2e-6: a row-split
matmul sums its partial products over the axis in another order than the
whole one, ~10 f32 ulps of the max here), two steps' updates (the
momentum, which the masters take as they are) 8.5e-7 of the largest
(bound 1e-6) and masters 5.6e-6 of the largest update (bound 1e-5: one
ulp of a master flips where its update differs in its last bit).
Replicated masters and momentum are bit-equal across the model ranks,
and all of a rank's shards across the data ranks. ``pinit``'s shards
equal the whole leaves' slices bit for bit, f32 and bf16. The CLI
(``--model-parallel 2 --comm xla``) reaches run_stop on every rank.

Without ranks: every leaf's spec is the reference's, sharding by it and
gathering back is the identity, and what the port does not split yet is
refused, naming its item (6.2d; 6.3: ``fsdp``), or, for a leaf that M
does not divide, saying that the reference cannot place it either; what
item 6.2c lifted (whisper, the VLM, heads that M does not divide,
checkpoints and ``--resume-elastic`` under ``--model-parallel``) and item
6.3's experts and MLA lifted (the MoE decoder with GQA or MLA over a
model axis and over data ranks) builds (``test_torch_tp_frames.py``,
``test_torch_tp_ckpt.py``, ``test_torch_tp_moe.py`` and
``test_torch_tp_mla.py`` hold it)."""
import dataclasses

import numpy as np
import pytest
import torch
import torch_ranks
import torch_reference as R

from repro.configs import get_config as jget_config
from repro.models import transformer as jtf
from repro_torch import weights
from repro_torch.configs import get_config
from repro_torch.core import lars, pinit
from repro_torch.core.schedule import ScheduleConfig, make_schedule
from repro_torch.launch.mesh import Axis, Mesh
from repro_torch.models import transformer
from repro_torch.models.common import local_slice, model_axis
from repro_torch.models.registry import build_model
from repro_torch.train.step import make_train_step
from repro_torch.tree import tree_flatten

#: (logits and caches, loss, masters of the update, momentum)
BOUNDS = {1: (1e-5, 1e-6, 5e-4, 1e-5), 0: (3e-2, 4e-4, 5e-2, 5e-2)}
SELF_LOGITS, SELF_UPDATE, SELF_MASTERS = 2e-6, 1e-6, 1e-5
#: comm='xla' at model 1 on two ranks against one rank on the whole batch:
#: (masters of the update, loss) differentiating the bf16 compute copy
#: (``test_torch_dp_frames.py``'s bounds) and wholly in f32
XLA_DP_BOUNDS = {0: (2.5e-2, 1.2e-4), 1: (5e-4, 1e-6)}


def _mesh(data: int, model: int, index: int = 0) -> Mesh:
    """A (data, model) mesh seen from the rank at model ``index``, with no
    process groups: what needs no collective reads it."""
    return Mesh((Axis("data", data, 0, tuple(range(0, data * model, model)),
                      None),
                 Axis("model", model, index, tuple(range(model)), None)),
                torch.device("cpu"))


@pytest.fixture(scope="module")
def ref_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ref") / "tp.npz")
    R.run("tp_cases", path, devices=4)
    return path


@pytest.fixture(scope="module")
def ranks(ref_path, tmp_path_factory):
    return torch_ranks.launch(f"lm_tp:{ref_path}", 4,
                              str(tmp_path_factory.mktemp("ranks")),
                              timeout=600)


@pytest.fixture(scope="module")
def xla_dp(tmp_path_factory):
    return torch_ranks.launch("lm_xla_dp", 2,
                              str(tmp_path_factory.mktemp("xla_dp")))


def _norm(spec):
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


@pytest.mark.tier1
@pytest.mark.parametrize("arch", (*R.TP_ARCHS, R.MOE_ARCH, R.MLA_ARCH,
                                  f"{R.MLA_ARCH}:full"))
def test_specs_are_the_references(arch):
    """Every leaf of the params and of the cache is split where the
    reference's ``PD.spec`` splits it (trailing unsplit dims aside): the
    MoE decoder's expert stacks on their expert dim, its router whole;
    MLA's heads' leaves, its latent projection, norm and cache whole.
    ``:full``: the published config (descriptors only), whose ``fsdp``
    puts ``data`` on the leaves too."""
    arch, _, full = arch.partition(":")
    jcfg, cfg = jget_config(arch), get_config(arch)
    if not full:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    pairs = [(jtf.lm_pd(jcfg), transformer.lm_pd(cfg)),
             (jtf.cache_pd(jcfg, 4, 16), transformer.cache_pd(cfg, 4, 16))]
    for jtree, tree in pairs:
        want = dict(tree_flatten(jtree))
        got = dict(tree_flatten(tree))
        assert set(want) == set(got)
        for path, pd in got.items():
            ref = _norm(tuple(want[path].spec))
            ref = ref + (None,) * (len(pd.shape) - len(ref))
            mine = _norm(pd.spec) + (None,) * (len(pd.shape) - len(pd.spec))
            assert mine == ref, (path, mine, ref)


@pytest.mark.tier1
@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("arch", R.TP_ARCHS)
def test_shard_and_gather_by_spec_is_the_identity(arch, m):
    """For every dense leaf: the M ranks' shards, put together along the
    split dim in rank order, give the leaf back bit for bit; a replicated
    leaf is every rank's whole."""
    cfg = get_config(arch).reduced()
    pd = transformer.lm_pd(cfg)
    full = pinit.materialize(pd, 3, "cpu")
    shards = [dict(tree_flatten(weights.shard_tree(full, pd, _mesh(1, m, r))))
              for r in range(m)]
    split = 0
    for path, leaf in tree_flatten(full):
        d = local_slice(dict(tree_flatten(pd))[path], model_axis(
            _mesh(1, m)))[0]
        if d is None:
            assert all(s[path] is leaf for s in shards)
            continue
        split += 1
        assert torch.equal(torch.cat([s[path] for s in shards], dim=d), leaf)
    assert split == 9 - cfg.tie_embeddings + 3 * cfg.qkv_bias


#: the refusal of a leaf the model axis does not divide, which the
#: reference cannot place either (``common.uneven_split``)
UNEVEN = "uneven"


def _refused(fn, item):
    match = (r"the reference cannot place either" if item == UNEVEN
             else rf"ROADMAP §1 item {item}\)")
    with pytest.raises(NotImplementedError, match=match):
        fn()


@pytest.mark.tier1
@pytest.mark.parametrize("arch,kw,mesh,item", [
    ("qwen2-moe-a2.7b", {}, (1, 2), None),          # ported: item 6.3
    ("qwen2-moe-a2.7b", {}, (1, 8), UNEVEN),         # 4 experts over 8
    # ported: item 6.3's MLA part (the ids name the item)
    pytest.param("deepseek-v2-236b", {}, (1, 2), None,
                 id="deepseek-v2-236b-kw2-mesh2-6.3"),
    pytest.param("deepseek-v2-236b", {"moe": None}, (1, 2), None,
                 id="deepseek-v2-236b-kw3-mesh3-6.3"),     # MLA alone
    ("zamba2-7b", {}, (1, 2), None),                # ported: item 6.2b
    ("xlstm-125m", {"d_model": 192}, (1, 2), None),
    ("xlstm-125m", {"n_layers": 7}, (1, 2), UNEVEN),  # sLSTM FFN 341
    ("zamba2-7b", {"vocab_size": 511}, (1, 2), UNEVEN),
    ("xlstm-125m", {"d_model": 192, "n_heads": 2, "n_kv_heads": 2}, (1, 4),
     "6.2d"),                                       # 2 heads over 4
    ("whisper-base", {}, (1, 2), None),             # ported: item 6.2c
    ("internvl2-2b", {}, (1, 2), None),
    ("qwen1.5-0.5b", {}, (1, 3), UNEVEN),           # 4 heads over 3
    ("qwen1.5-0.5b", {"d_ff": 511}, (1, 2), UNEVEN),
    ("qwen1.5-0.5b", {"vocab_size": 511}, (1, 2), UNEVEN),
    ("qwen1.5-0.5b", {"n_kv_heads": 1}, (1, 2), None),   # MQA: gathered
    ("qwen1.5-32b", {"fsdp": True}, (2, 2), "6.3"),
])
def test_model_axis_refuses_what_it_does_not_split(arch, kw, mesh, item):
    """Each configuration outside the slice raises with its ROADMAP item
    (a leaf that M does not divide: that the reference cannot place it
    either), in the forward and in ``make_train_step(comm='xla')``,
    before any collective: nothing falls back. The rows whose item is
    None are ported (the hybrid and the xLSTM, item 6.2b; whisper, the VLM
    and a kv head fewer than M, item 6.2c; the MoE layer's experts and
    MLA, item 6.3): each builds."""
    cfg = dataclasses.replace(get_config(arch).reduced(), **kw)
    m = _mesh(*mesh)
    model = build_model(cfg)
    build = lambda: make_train_step(  # noqa: E731
        model, lars.OptConfig(), make_schedule(ScheduleConfig(
            base_lr=0.1, total_steps=2)), mesh=m, comm="xla")
    if item is None:
        assert transformer.tp_axis(cfg, m).size == mesh[1]
        assert build().mesh is m
        return
    _refused(lambda: transformer.tp_axis(cfg, m), item)
    _refused(build, item)


@pytest.mark.tier1
def test_xla_step_refusals_over_a_multi_rank_mesh():
    """What item 6.2b lifted builds: the conv family under comm='xla'
    over several ranks (its BatchNorm statistics over the data axes), the
    guard over a model axis, and LAMB over it (its norms the rank's own
    where no leaf is split: the no-axis update). What item 6.3 lifted
    builds: the MoE decoder over data ranks alone and over (data, model),
    and so does MLA (item 6.3's MLA part)."""
    sched = make_schedule(ScheduleConfig(base_lr=0.1, total_steps=2))
    resnet = build_model(get_config("resnet50").reduced())
    for mesh in ((2, 1), (1, 1), (2, 2)):
        make_train_step(resnet, lars.OptConfig(), sched, mesh=_mesh(*mesh),
                        comm="xla")
    lm = build_model(get_config("qwen1.5-0.5b").reduced())
    assert make_train_step(lm, lars.OptConfig(), sched, mesh=_mesh(1, 2),
                           comm="xla", guard=True).guarded
    p = {"w": torch.ones(2, 2)}
    args = (p, p, lars.init_momentum(p, "lamb"), 0.1,
            lars.OptConfig(kind="lamb"))
    got = lars.update(*args, model_axis=model_axis(_mesh(1, 2)))
    assert torch.equal(got[0]["w"], lars.update(*args)[0]["w"])
    moe = build_model(get_config("qwen2-moe-a2.7b").reduced())
    for mesh in ((2, 1), (2, 2)):
        assert make_train_step(moe, lars.OptConfig(), sched,
                               mesh=_mesh(*mesh), comm="xla").mesh.size \
            == mesh[0] * mesh[1]
    mla = build_model(get_config("deepseek-v2-236b").reduced())
    for mesh in ((2, 1), (2, 2)):
        assert make_train_step(mla, lars.OptConfig(), sched,
                               mesh=_mesh(*mesh), comm="xla").mesh.size \
            == mesh[0] * mesh[1]


@pytest.mark.tier1
@pytest.mark.parametrize("argv,item", [
    (["--arch", "qwen2-moe-a2.7b"], None),
    # ported: item 6.3's MLA part (the id names the item)
    pytest.param(["--arch", "deepseek-v2-236b"], None, id="argv1-6.3"),
    (["--arch", "zamba2-7b"], None),
    (["--arch", "resnet50"], None),
    (["--arch", "whisper-base"], None),
    (["--arch", "internvl2-2b"], None),
    (["--arch", "qwen1.5-0.5b", "--ckpt-dir", "ck"], None),
    (["--arch", "qwen1.5-0.5b", "--ckpt-dir", "ck", "--resume-elastic"],
     None),
    (["--arch", "qwen1.5-0.5b", "--guard"], None),
])
def test_cli_model_parallel_refusals(argv, item, capsys, monkeypatch):
    """``--model-parallel 2`` under a two-rank launch: what the slice does
    not cover exits before anything is built, naming its item; what it
    covers (item None: the hybrid, ResNet-50, the guard, whisper, the VLM,
    checkpoints and ``--resume-elastic``, the MoE decoder with GQA or
    MLA) reaches the run."""
    from repro_torch.launch import train as cli
    monkeypatch.setenv("WORLD_SIZE", "2")
    ran = []
    monkeypatch.setattr(cli, "_run", ran.append if item is None
                        else (lambda args: pytest.fail("ran")))
    argv = [*argv, "--reduced", "--model-parallel", "2", "--device", "cpu"]
    if item is None:
        cli.main(argv)
        assert len(ran) == 1 and ran[0].model_parallel == 2
        return
    with pytest.raises(SystemExit) as exit_info:
        cli.main(argv)
    assert exit_info.value.code != 0
    assert f"ROADMAP §1 item {item})" in capsys.readouterr().err


# ------------------------------------------------- four gloo ranks


def _each(ranks, key):
    vals = [np.asarray(r[key]) for r in ranks]
    for v in vals[1:]:           # every rank gathered the same outputs
        np.testing.assert_array_equal(v, vals[0])
    return vals[0]


@pytest.mark.tier2
@pytest.mark.parametrize("f32", [0, 1])
@pytest.mark.parametrize("arch", R.TP_ARCHS)
def test_model_axis_meets_the_reference(ranks, arch, f32):
    """Prefill, forward and decode logits, the caches, the greedy tokens
    (asserted on each rank by ``check_greedy_tokens``) and two steps."""
    logits, loss, masters, mom = BOUNDS[f32]
    pre = f"{arch}/f{f32}"
    for name in ("train_logits", "prefill_logits", "decode_logits",
                 "cache", "decode_cache"):
        assert _each(ranks, f"{pre}/{name}") <= logits, name
    d_loss, d_masters, d_mom = _each(ranks, f"{pre}/step")
    assert d_loss <= loss and d_masters <= masters and d_mom <= mom, \
        (d_loss, d_masters, d_mom)


@pytest.mark.tier2
@pytest.mark.parametrize("arch", R.TP_ARCHS)
def test_model_axis_sgdm_steps_meet_the_reference(ranks, arch):
    """Two f32 sgdm steps (whose update scales with the gradient, as
    LARS's trust ratio does not): a gradient that the model axis sums
    or drops shows in the masters and the momentum."""
    _, loss, masters, mom = BOUNDS[1]
    d_loss, d_masters, d_mom = _each(ranks, f"{arch}/sgdm/step")
    assert d_loss <= loss and d_masters <= masters and d_mom <= mom, \
        (d_loss, d_masters, d_mom)


@pytest.mark.tier2
def test_model_axis_flash_path_meets_the_reference(ranks):
    """``flash_attention=True``: K5's plain version on each rank's heads
    against the reference's interpret-mode kernel in ``shard_map``."""
    for name in ("train_logits", "prefill_logits", "decode_logits",
                 "cache", "decode_cache"):
        assert _each(ranks, f"flash/{name}") <= BOUNDS[0][0], name


@pytest.mark.tier2
@pytest.mark.parametrize("variant", list(torch_ranks.TP_VARIANTS))
def test_model_2_equals_model_1_in_f32(ranks, variant):
    assert _each(ranks, f"self/{variant}/logits") <= SELF_LOGITS
    assert _each(ranks, f"self/{variant}/mom") <= SELF_UPDATE
    assert _each(ranks, f"self/{variant}/masters") <= SELF_MASTERS


@pytest.mark.tier2
@pytest.mark.parametrize("variant", list(torch_ranks.TP_VARIANTS))
def test_masters_bit_equal_where_replicated(ranks, variant):
    """Rank ``d·2 + m``: the replicated leaves' masters and momentum are
    the same bits on every rank; all of a rank's shards are its data
    twin's."""
    rep = [bytes(r[f"self/{variant}/sha_rep"]) for r in ranks]
    both = [bytes(r[f"self/{variant}/sha_all"]) for r in ranks]
    assert len(set(rep)) == 1
    assert both[0] == both[2] and both[1] == both[3] and both[0] != both[1]


@pytest.mark.tier2
def test_pinit_shards_and_cli(ranks):
    assert all(bool(r["pinit"]) for r in ranks)
    assert all(bool(r["cli"]) for r in ranks)


@pytest.mark.tier2
@pytest.mark.parametrize("arch", torch_ranks.xla_dp_archs())
def test_comm_xla_at_model_1_equals_one_rank(xla_dp, arch):
    """``comm='xla'`` over two ranks at model 1 (GSPMD's pure data
    parallelism), each rank on its rows and frames, against the one-rank
    step on the whole batch; both ranks read the same masters, bit for
    bit, and hold as many labels."""
    update, loss = XLA_DP_BOUNDS[arch in R.LM_FAMILY_F32]
    for r in xla_dp:
        assert float(r[f"{arch}/masters_of_update"]) <= update
        assert float(r[f"{arch}/loss_rel"]) <= loss
    for key in ("masters_sha", "labels"):
        _each(xla_dp, f"{arch}/{key}")


@pytest.mark.tier2
def test_cli_comm_xla_at_model_1_over_two_ranks(xla_dp):
    """``--comm xla`` with whisper-base under a two-rank launch reaches
    run_stop on each rank."""
    assert all(bool(r["cli"]) for r in xla_dp)
