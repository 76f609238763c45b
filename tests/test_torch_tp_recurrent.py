"""The model axis (ROADMAP §1 item 6.2b) for the hybrid and the xLSTM: the
reduced zamba2-7b (4 Mamba layers in 2 groups, 16 SSM heads of 32, the
shared block's 4 heads) and the xLSTM (an mLSTM and an sLSTM block, 4
heads, d 192: ``torch_reference.tp_config``) over a (data 2, model 2) mesh
of four gloo ranks (``torch_ranks.py lm_tp_recurrent``), against the JAX
package's GSPMD program on a (2, 2) Auto-axis mesh of four host devices
(``torch_reference.py tp_recurrent_cases``: one subprocess, a thread a
program, its params placed by their specs), wholly in f32 (the port under
``precision.f32_compute``, the reference under ``_jax_f32_compute``, the
steps differentiating the f32 masters), the recurrent families' gate.

Held against the reference, with the worst figures measured here (hybrid /
xLSTM): the forward's, the prefill's and one decode step's logits 2.9e-6
/ 2.0e-6 of their max and every cache leaf (gathered over both axes: the
shared block's k and v, the Mamba layers' conv windows and states, the
xLSTM's states) 2.8e-6 / 2.5e-6, the greedy tokens (``check_greedy_tokens``
on each rank's rows), and two LARS and two sgdm ``comm='xla'`` steps from
the reference's own inputs: loss 7.2e-8 relative, masters 1.1e-4 / 9.4e-5
of their tensor's largest update, momentum 6.0e-6 / 2.9e-6 of its largest
element; the sLSTM's input-gate bias, whose gradient vanishes (its update
is its weight decay and rounding noise, as in ``test_torch_xlstm.py``),
apart: 3.0e-3 and 8.5e-5. Bounds: ``test_torch_tp.py``'s f32 bounds, 1e-5
(logits, caches), 1e-6 (loss), 5e-4 (masters), 1e-5 (momentum), and
``test_torch_xlstm.py``'s 1e-2 for the vanishing bias. The hybrid's LAMB
step (from m 0 and v 1e-4: ``torch_reference.LAMB_V0``; its trust ratio
from whole-tensor norms over the axis): masters 6.1e-6 of the update, m
6.5e-6 and v 1.6e-6 of their largest (bounds 5e-4, 1e-5, 1e-5). Its
guarded LARS step: with neutral inputs the step above and gnorm 8.0e-8
relative (bound 1e-5), not skipped, as the reference; with an infinite
loss scale skipped on every rank, its input state returned, as the
reference's. Within the port, model 2 against the full tree with no mesh:
logits 2.3e-6 / 9.1e-7 of their max (bound 5e-6: a split sum of squares
and a row-split matmul sum in another order), two steps' momentum 2.3e-6 /
1.4e-6 of the largest and masters 4.3e-6 / 5.1e-6 of the largest update
(bounds 5e-6 and 1e-5). Replicated masters and momentum are bit-equal
across the model ranks, and all of a rank's shards across the data ranks.
``pinit``'s shards equal the whole leaves' slices bit for bit, f32 and
bf16. The CLI (``--arch zamba2-7b --model-parallel 2 --comm xla
--guard``) reaches run_stop on every rank.

Without ranks: every leaf's spec (params and caches) is the reference's,
and sharding by it and gathering back is the identity at model 2 and 4."""
import numpy as np
import pytest
import torch
import torch_ranks
import torch_reference as R

from repro.configs import get_config as jget_config
from repro.models import transformer as jtf
from repro_torch import weights
from repro_torch.configs import get_config
from repro_torch.core import pinit
from repro_torch.launch.mesh import Axis, Mesh
from repro_torch.models import transformer
from repro_torch.models.common import local_slice, model_axis
from repro_torch.tree import tree_flatten

#: (logits and caches, loss, masters of the update, momentum), and the
#: vanishing-gradient leaves' (masters, momentum)
BOUNDS = (1e-5, 1e-6, 5e-4, 1e-5)
ZERO_BOUNDS = (1e-2, 1e-2)
#: the hybrid's LAMB step: (loss, masters of the update, m, v)
LAMB_BOUNDS = (1e-6, 5e-4, 1e-5, 1e-5)
GNORM_RTOL = 1e-5
SELF_LOGITS, SELF_UPDATE, SELF_MASTERS = 5e-6, 5e-6, 1e-5


def _mesh(model: int, index: int = 0) -> Mesh:
    """A (data 1, model ``model``) mesh seen from the rank at model
    ``index``, with no process groups."""
    return Mesh((Axis("data", 1, 0, (0,), None),
                 Axis("model", model, index, tuple(range(model)), None)),
                torch.device("cpu"))


@pytest.fixture(scope="module")
def ref_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ref") / "tp_recurrent.npz")
    R.run("tp_recurrent_cases", path, devices=4)
    return path


@pytest.fixture(scope="module")
def ranks(ref_path, tmp_path_factory):
    return torch_ranks.launch(f"lm_tp_recurrent:{ref_path}", 4,
                              str(tmp_path_factory.mktemp("ranks")),
                              timeout=600)


def _norm(spec, n):
    spec = tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)
    return spec + (None,) * (n - len(spec))


@pytest.mark.tier1
@pytest.mark.parametrize("arch", R.TP_RECURRENT_ARCHS)
def test_specs_are_the_references(arch):
    """Every leaf of the params and of the cache is split where the
    reference's ``PD.spec`` splits it (trailing unsplit dims aside)."""
    jcfg, cfg = R.tp_config(jget_config, arch), R.tp_config(get_config, arch)
    pairs = [(jtf.lm_pd(jcfg), transformer.lm_pd(cfg)),
             (jtf.cache_pd(jcfg, 4, 16), transformer.cache_pd(cfg, 4, 16))]
    for jtree, tree in pairs:
        want = dict(tree_flatten(jtree))
        got = dict(tree_flatten(tree))
        assert set(want) == set(got)
        for path, pd in got.items():
            n = len(pd.shape)
            assert _norm(pd.spec, n) == _norm(tuple(want[path].spec), n), \
                (path, pd.spec, want[path].spec)


@pytest.mark.tier1
@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("arch", R.TP_RECURRENT_ARCHS)
def test_shard_and_gather_by_spec_is_the_identity(arch, m):
    """The model axis admits the family, and the M ranks' shards of each
    split leaf, put together in rank order, give it back bit for bit; a
    replicated leaf is every rank's whole."""
    cfg = R.tp_config(get_config, arch)
    assert transformer.tp_axis(cfg, _mesh(m)).size == m
    pd = transformer.lm_pd(cfg)
    full = pinit.materialize(pd, 3, "cpu")
    shards = [dict(tree_flatten(weights.shard_tree(full, pd, _mesh(m, r))))
              for r in range(m)]
    pds = dict(tree_flatten(pd))
    split = 0
    for path, leaf in tree_flatten(full):
        d = local_slice(pds[path], model_axis(_mesh(m)))[0]
        if d is None:
            assert all(s[path] is leaf for s in shards)
            continue
        split += 1
        assert torch.equal(torch.cat([s[path] for s in shards], dim=d), leaf)
    assert split > 0


# ------------------------------------------------- four gloo ranks


def _each(ranks, key):
    vals = [np.asarray(r[key]) for r in ranks]
    for v in vals[1:]:           # every rank gathered the same outputs
        np.testing.assert_array_equal(v, vals[0])
    return vals[0]


@pytest.mark.tier2
@pytest.mark.parametrize("arch", R.TP_RECURRENT_ARCHS)
def test_model_axis_meets_the_reference(ranks, arch):
    """Prefill, forward and decode logits and every cache leaf; the
    greedy tokens are asserted on each rank by ``check_greedy_tokens``."""
    for name in ("train_logits", "prefill_logits", "decode_logits",
                 "cache", "decode_cache"):
        assert _each(ranks, f"{arch}/{name}") <= BOUNDS[0], name


@pytest.mark.tier2
@pytest.mark.parametrize("kind", ["step", "sgdm/step"])
@pytest.mark.parametrize("arch", R.TP_RECURRENT_ARCHS)
def test_model_axis_steps_meet_the_reference(ranks, arch, kind):
    """Two LARS and two sgdm steps (sgdm's update scales with the
    gradient, as LARS's trust ratio does not): a gradient that the model
    axis sums or drops shows in the masters and the momentum."""
    got = _each(ranks, f"{arch}/{kind}")
    assert got[0] <= BOUNDS[1] and got[1] <= BOUNDS[2] \
        and got[2] <= BOUNDS[3], got
    if len(got) > 3:
        assert got[3] <= ZERO_BOUNDS[0] and got[4] <= ZERO_BOUNDS[1], got


@pytest.mark.tier2
def test_lamb_over_the_model_axis_meets_the_reference(ranks):
    got = _each(ranks, f"{R.HYBRID_ARCH}/lamb")
    assert (got <= np.array(LAMB_BOUNDS)).all(), got


@pytest.mark.tier2
def test_guarded_step_over_the_model_axis_meets_the_reference(ranks):
    """With neutral inputs: the step, its gnorm over every rank's shards
    and its decision (not skipped) are the reference's."""
    loss, masters, mom, gnorm, skipped = _each(
        ranks, f"{R.HYBRID_ARCH}/guard/ok")
    assert loss <= BOUNDS[1] and masters <= BOUNDS[2] and mom <= BOUNDS[3]
    assert gnorm <= GNORM_RTOL and skipped == 0


@pytest.mark.tier2
def test_guard_skips_on_every_rank_as_the_reference(ranks):
    """An infinite loss scale: every rank counts the nonfinite gradients,
    skips as the reference does and returns its input state."""
    assert _each(ranks, f"{R.HYBRID_ARCH}/guard/bad").all()


@pytest.mark.tier2
@pytest.mark.parametrize("arch", R.TP_RECURRENT_ARCHS)
def test_model_2_equals_model_1_in_f32(ranks, arch):
    assert _each(ranks, f"self/{arch}/logits") <= SELF_LOGITS
    assert _each(ranks, f"self/{arch}/mom") <= SELF_UPDATE
    assert _each(ranks, f"self/{arch}/masters") <= SELF_MASTERS


@pytest.mark.tier2
@pytest.mark.parametrize("arch", R.TP_RECURRENT_ARCHS)
def test_masters_bit_equal_where_replicated(ranks, arch):
    """Rank ``d·2 + m``: the replicated leaves' masters and momentum are
    the same bits on every rank; all of a rank's shards are its data
    twin's."""
    rep = [bytes(r[f"self/{arch}/sha_rep"]) for r in ranks]
    both = [bytes(r[f"self/{arch}/sha_all"]) for r in ranks]
    assert len(set(rep)) == 1
    assert both[0] == both[2] and both[1] == both[3] and both[0] != both[1]


@pytest.mark.tier2
def test_pinit_shards_are_the_whole_leaves_slices(ranks):
    """``pinit.materialize(mesh=)``: each rank's shard of every leaf (the
    stacked Mamba leaves among them), f32 and bf16, is the whole leaf's
    slice bit for bit."""
    assert all(bool(r["pinit"]) for r in ranks)


@pytest.mark.tier2
def test_cli_hybrid_at_model_2_with_the_guard(ranks):
    assert all(bool(r["cli"]) for r in ranks)
