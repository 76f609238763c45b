"""Checkpoints under the model axis (ROADMAP §3 fault 3.7, §1 item 6.2c):
the ``comm='xla'`` step over a (data, model) mesh holds each rank's
slices of the split leaves, and the file holds the reference's whole
arrays all the same (``checkpoint.save`` gathers them by the step's
``param_pd``; ``checkpoint.load`` cuts this rank's slices back out).

Four gloo ranks (``torch_ranks.py lm_tp_ckpt``) run the reduced
qwen1.5-0.5b at (data 2, model 2) through ``loop.train(ckpt_dir=...)``
and hold, bit for bit: the committed file's split leaves at their whole
shapes (before the repair the file held rank 0's slices under the whole
leaves' names, and a load gave every rank rank 0's slices: fault 3.7),
each rank's load its own slices, the file's bytes a key those of a file
written at model 1 from the same state gathered whole, the reference's
``repro.train.checkpoint.load`` reading it into its own ``init_state``
template, the port at (2, 2) loading a file the reference saved, the
(2, 2) file resumed at (1, 4) and (4, 1) (``elastic.load_resharded``)
with its masters whole again after a gather, a resumed run ending on
the uninterrupted run's masters, LAMB's two moments alike, and the CLI's
``--ckpt-dir`` at ``--model-parallel 2`` resumed by ``--resume-elastic``
at ``--model-parallel 4``. Without ranks: the load's cut on a mesh seen
from model rank 1, and its refusals."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_ranks

from repro.configs import get_config as jget_config
from repro.models.registry import build_model as jbuild_model
from repro.train import checkpoint as jckpt
from repro.train import state as jstate
from repro_torch import weights
from repro_torch.configs import get_config
from repro_torch.launch.mesh import Axis, Mesh
from repro_torch.models import transformer
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.state import TrainState
from repro_torch.tree import tree_flatten, tree_unflatten

ARCH = "qwen1.5-0.5b"


def _mesh(data: int, model: int, index: int) -> Mesh:
    """A (data, model) mesh seen from model rank ``index``, with no
    process groups: what needs no collective reads it."""
    return Mesh((Axis("data", data, 0, tuple(range(0, data * model, model)),
                      None),
                 Axis("model", model, index, tuple(range(model)), None)),
                torch.device("cpu"))


def _np_tree(pd_tree, seed):
    rng = np.random.default_rng(seed)
    flat = tree_flatten(pd_tree)
    return tree_unflatten([p for p, _ in flat], [
        rng.standard_normal(tuple(pd.shape)).astype(np.float32)
        for _, pd in flat])


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def ref_dir(tmp_path_factory):
    """A checkpoint the reference saved: a reduced qwen1.5-0.5b state
    built from numpy, its whole arrays."""
    pd = transformer.lm_pd(get_config(ARCH).reduced())
    d = str(tmp_path_factory.mktemp("ref_ckpt"))
    state = jstate.TrainState(jnp.int32(3), _map(jnp.asarray, _np_tree(pd, 1)),
                              _map(jnp.asarray, _np_tree(pd, 2)))
    jckpt.save(state, d, tag=jckpt.step_tag(3))
    return d


@pytest.fixture(scope="module")
def ranks_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("ranks"))


@pytest.fixture(scope="module")
def ranks(ref_dir, ranks_dir):
    return torch_ranks.launch(f"lm_tp_ckpt:{ref_dir}", 4, ranks_dir,
                              timeout=600)


def _all(ranks, key):
    return all(bool(r[key]) for r in ranks)


# ---------------------------------------------------------- no ranks


def _whole_file(tmp_path, pd, seed=1):
    """A model-1 file of a state drawn from numpy; returns (dir, params)."""
    params = _map(torch.from_numpy, _np_tree(pd, seed))
    mom = _map(torch.zeros_like, params)
    ckpt.save(TrainState(2, params, mom), str(tmp_path), tag="w")
    return str(tmp_path), params


@pytest.mark.tier1
@pytest.mark.parametrize("index", [0, 1])
def test_load_cuts_whole_leaves_by_spec(tmp_path, index):
    """A whole file loaded on model rank ``index`` of a (1, 2) mesh gives
    ``weights.shard_tree``'s cut of every leaf, bit for bit, at the
    template's shapes."""
    cfg = get_config(ARCH).reduced()
    pd = transformer.lm_pd(cfg)
    mesh = _mesh(1, 2, index)
    d, params = _whole_file(tmp_path, pd)
    cut = weights.shard_tree(params, pd, mesh)
    template = TrainState(0, _map(torch.zeros_like, cut),
                          _map(torch.zeros_like, cut))
    got = ckpt.load(template, d, tag="w", mesh=mesh, param_pd=pd)
    assert got.step == 2
    for (p, a), (_, b) in zip(tree_flatten(got.params), tree_flatten(cut)):
        assert torch.equal(a, b), p


@pytest.mark.tier1
def test_load_refuses_a_file_of_slices(tmp_path):
    """Fault 3.7's files (a rank's slices under the whole leaves' names)
    and any other shape of a split leaf raise CheckpointMismatchError,
    naming the leaf."""
    cfg = get_config(ARCH).reduced()
    pd = transformer.lm_pd(cfg)
    mesh = _mesh(1, 2, 1)
    params = weights.shard_tree(_map(torch.from_numpy, _np_tree(pd, 1)), pd,
                                mesh)
    state = TrainState(1, params, _map(torch.zeros_like, params))
    ckpt.save(state, str(tmp_path), tag="slices")       # no mesh: as is
    with pytest.raises(ckpt.CheckpointMismatchError,
                       match=r"params\|embed: .*one rank's slice"):
        ckpt.load(state, str(tmp_path), tag="slices", mesh=mesh,
                  param_pd=pd)


# ---------------------------------------------------------- four ranks


@pytest.mark.tier2
def test_fault_3_7_file_holds_whole_leaves(ranks):
    """The committed file's split leaves (params and momentum) have the
    reference's whole shapes, and its arrays are the state gathered."""
    assert _all(ranks, "whole")
    assert bool(ranks[0]["file_is_state"])


@pytest.mark.tier2
def test_fault_3_7_each_rank_loads_its_own_slices(ranks):
    """Each rank's load is its own state's slices, bit for bit; the two
    model ranks of a data row load different slices, each data twin the
    same."""
    assert _all(ranks, "own")
    sha = [bytes(r["own_sha"]) for r in ranks]
    assert sha[0] == sha[2] and sha[1] == sha[3] and sha[0] != sha[1]


@pytest.mark.tier2
def test_file_at_2x2_is_bytes_of_model_1(ranks):
    """Every key's bytes equal those of the file written at model 1 from
    the same state gathered whole."""
    assert bool(ranks[0]["bytes"])


@pytest.mark.tier2
def test_reference_reads_the_port_file(ranks, ranks_dir):
    """The reference's ``checkpoint.load`` reads the (2, 2) file into its
    own ``init_state`` template, bit for bit."""
    jmodel = jbuild_model(jget_config(ARCH).reduced())
    template = jstate.init_state(jmodel, 0)
    got = jckpt.load(template, os.path.join(ranks_dir, "tp"),
                     tag=jckpt.step_tag(1))
    assert int(got.step) == 1
    for field in ("params", "mom"):
        for key, v in jckpt._flatten(getattr(got, field)).items():
            want = ranks[0][f"whole/{field}|{key}"]
            assert v.dtype == want.dtype and v.tobytes() == want.tobytes(), \
                key


@pytest.mark.tier2
def test_port_loads_a_reference_file_at_2x2(ranks):
    assert _all(ranks, "ref")


@pytest.mark.tier2
@pytest.mark.parametrize("m", [4, 1])
def test_elastic_resume_onto_another_mesh(ranks, m):
    """The (2, 2) file resumed at (data 4 / m, model m): the masters and
    momentum, gathered, are the file's bit for bit; one step from them
    is finite."""
    assert _all(ranks, f"elastic/{m}")
    assert _all(ranks, f"elastic/{m}/finite")


@pytest.mark.tier2
def test_resumed_run_is_bit_exact(ranks):
    assert _all(ranks, "resume")


@pytest.mark.tier2
def test_lamb_moments_saved_whole(ranks):
    assert _all(ranks, "lamb/whole")
    assert _all(ranks, "lamb/own")


@pytest.mark.tier2
def test_explicit_schedule_state_saved_whole_as_it_is(ranks):
    """An explicit schedule over the same (data 2, model 2) mesh keeps
    every leaf whole on every rank: its checkpoint holds the state as it
    is and loads back bit for bit (nothing gathered or cut)."""
    assert _all(ranks, "explicit")


@pytest.mark.tier2
def test_cli_ckpt_and_resume_elastic_over_model_axis(ranks):
    """``--ckpt-dir --ckpt-every 1`` at ``--model-parallel 2``, then
    ``--resume-elastic`` at ``--model-parallel 4``: resumed at step 2,
    run_stop on every rank."""
    assert _all(ranks, "cli")
