"""MLA over the model axis (ROADMAP §1 item 6.3's MLA part): ``wq``,
``wk_b`` and ``wv_b`` split their heads' columns and ``wo`` its rows,
``wkv_a`` and ``ckv_norm`` whole on every rank, the latent cache whole on
every rank; ``mla_parallel`` and the absorbed decode over a rank's H/M
heads, one all-reduce a block. Held against the JAX package's GSPMD
program on four host devices (``torch_reference.py tp_mla_cases``: four
subprocesses at once, the block, the LM's runs and its bf16 and f32
steps, the reference's MoE layer and flash path in ``shard_map`` under
the shim) from four gloo ranks (``torch_ranks.py lm_tp_mla``, ~7 s
alone).

The block (the reduced deepseek-v2-236b's: 4 heads, kv_lora 64, rope 16,
nope 32, v 32) on (2, 2) and (1, 4) Auto-axis meshes, in f32 and bf16:
the prefill's out and latent cache, the absorbed decode from the
reference's cache (out and the cache with its new row), on (2, 2) the
bf16 prefill through K5's plain version on the rank's heads against the
Pallas kernel in ``shard_map``, and the f32 gradients of ``sum(out ·
ct)`` (params summed over the data ranks and gathered over ``model``; the
replicated ``wkv_a`` and ``ckv_norm`` each rank's own, so every rank must
hold the same). Measured: f32 prefill 2.5e-7 (2, 2) and 6.0e-7 (1, 4) of
the reference's largest, decode 4.0e-7 and 3.3e-7, gradients 4.2e-7;
bf16 prefill 1.4e-3 and 5.6e-3, decode 0 and 5.3e-3, flash 6.9e-4.
Bounds: ``test_torch_tp.py``'s 1e-5 (f32) and 3e-2 (bf16).

The LM (the reduced deepseek-v2-236b at (2, 2)): the forward over the
32-token prompt (the MoE layer cannot shard 33 over model 2), the
prefill, one decode step, the latent caches and the greedy tokens; two
``comm='xla'`` steps from the reference's own inputs. Measured: bf16
logits 5.6e-3 of their max, caches 7.8e-3; f32 logits 1.2e-6, caches
1.0e-6. Steps: f32 loss 1.4e-7 relative, masters 8.3e-5 of the largest
update, momentum 2.4e-6, every layer's expert ids the reference device's;
bf16 on the reference device's expert choices (as ``test_torch_mla.py``'s
one-device steps: unpinned, one token-layer of rank 0's takes another
expert, its 2nd and 3rd router probabilities 1.0e-3 apart, and that
expert's update parts by 0.12 of the largest) loss 1.1e-4, masters and
momentum 1.9e-2. Bounds: ``test_torch_tp.py``'s. Two f32 steps at (data
4, model 1) from the reference's inputs: loss 7.0e-8, masters 8.2e-5,
momentum 2.1e-6 (the same bounds).

Within the port, in f32: the LM at (2, 2) against the one-device port with
the MoE layer chunked as the mesh chunks it: logits 1.0e-6 (bound 2e-6),
two LARS steps' masters 5.1e-6 of the largest update and momentum 6.6e-7
(bounds 1e-5); the replicated masters (``wkv_a``, ``ckv_norm``, the
router, the norms) bit-equal across the model ranks. An MLA checkpoint
saved at (2, 2) equals the model-1 file key by key and loads at (1, 4).
The reduced ``--comm xla`` CLI reaches run_stop at --model-parallel 2.

Without ranks: MLA's heads that M does not divide are refused (item
6.3c), and ``fsdp`` over more than one data rank still is (item 6.3), at
model 1 too.

Cost: ~41 s alone (the fixtures ~30 s: the reference's parts ~19 s at
once, ranks ~7 s). In the driver's six-worker run, with the reference in
two parts (the LM's runs and steps in one, ~27 s alone), the file took
128.6 s of worker time, over its 100 s budget; hence four parts."""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import torch_ranks
import torch_reference as R

from repro_torch.configs import get_config
from repro_torch.core import lars
from repro_torch.core.schedule import ScheduleConfig, make_schedule
from repro_torch.launch.mesh import Axis, Mesh
from repro_torch.models import transformer
from repro_torch.models.common import local_slice
from repro_torch.models.registry import build_model
from repro_torch.train.step import make_train_step

#: the block's figures, by dtype
BLOCK_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
#: test_torch_tp.py's: (logits and caches, loss, masters of the update,
#: momentum) in bf16 (0) and f32 (1)
BOUNDS = {1: (1e-5, 1e-6, 5e-4, 1e-5), 0: (3e-2, 4e-4, 5e-2, 5e-2)}
#: the model-axis LM against the one-device port: logits, then masters
#: and momentum (test_torch_tp_moe.py's)
SELF_LOGITS, SELF_STEP = 2e-6, 1e-5
#: the token-layers of a rank's two bf16 steps whose own expert choice
#: differs from the reference device's (measured: 1, on rank 0), of 128
TIED_CHOICES = 2


@pytest.fixture(scope="module")
def ref_paths(tmp_path_factory):
    """The reference's parts, a subprocess each, all at once."""
    d = tmp_path_factory.mktemp("ref")
    paths = [str(d / f"tp_mla_{part}.npz") for part in R.TP_MLA_PARTS]
    with ThreadPoolExecutor(len(paths)) as pool:
        for done in [pool.submit(R.run, f"tp_mla_cases:{part}", path,
                                 devices=4)
                     for part, path in zip(R.TP_MLA_PARTS, paths)]:
            done.result()
    return ",".join(paths)


@pytest.fixture(scope="module")
def ranks(ref_paths, tmp_path_factory):
    return torch_ranks.launch(f"lm_tp_mla:{ref_paths}", 4,
                              str(tmp_path_factory.mktemp("ranks")),
                              timeout=600)


def _each(ranks, key):
    vals = [np.asarray(r[key]) for r in ranks]
    for v in vals[1:]:           # every rank gathered the same outputs
        np.testing.assert_array_equal(v, vals[0])
    return vals[0]


# ---------------------------------------------------------------- in process


def _mesh(data: int, model: int) -> Mesh:
    """A (data, model) mesh seen from rank 0, with no process groups: a
    collective on it would fail."""
    return Mesh((Axis("data", data, 0, tuple(range(0, data * model, model)),
                      None),
                 Axis("model", model, 0, tuple(range(model)), None)),
                torch.device("cpu"))


@pytest.mark.tier1
@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_mla_over_the_model_axis_is_accepted(shape):
    """The reduced config over (2, 2) and (1, 4), and the full
    deepseek-v2-236b over (1, 4) (its ``fsdp`` at one data rank), place
    MLA: ``tp_axis`` and ``make_train_step(comm='xla')`` take them, the
    step splitting the heads' leaves alone."""
    mesh = _mesh(*shape)
    for cfg in (get_config(R.MLA_ARCH).reduced(), get_config(R.MLA_ARCH)):
        if cfg.fsdp and shape[0] > 1:
            continue
        assert transformer.tp_axis(cfg, mesh).size == shape[1]
    step = make_train_step(build_model(get_config(R.MLA_ARCH).reduced()),
                           lars.OptConfig(),
                           make_schedule(ScheduleConfig(**R.LR)),
                           mesh=mesh, comm="xla")
    attn = step.param_pd["layers"]["attn"]
    split = {k for k, pd in attn.items()
             if local_slice(pd, mesh.axis("model"))[0] is not None}
    assert split == {"wq", "wk_b", "wv_b", "wo"}


@pytest.mark.tier1
@pytest.mark.parametrize("heads,m", [(6, 4), (2, 4)])
def test_heads_the_axis_does_not_divide_are_refused(heads, m):
    """MLA's n_heads that M does not divide, where every leaf does (6 or 2
    heads over model 4: a rank's columns cut a head): item 6.3c, in
    the forward and in the step, before any collective."""
    import dataclasses
    cfg = dataclasses.replace(get_config(R.MLA_ARCH).reduced(),
                              n_heads=heads, n_kv_heads=heads)
    mesh = _mesh(1, m)
    with pytest.raises(NotImplementedError, match=r"item 6\.3c"):
        transformer.tp_axis(cfg, mesh)
    with pytest.raises(NotImplementedError, match=r"item 6\.3c"):
        make_train_step(build_model(cfg), lars.OptConfig(),
                        make_schedule(ScheduleConfig(**R.LR)), mesh=mesh,
                        comm="xla")


@pytest.mark.tier1
@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
def test_fsdp_over_data_ranks_is_still_refused(shape):
    """deepseek-v2-236b's ``fsdp`` (the masters split over data) over
    more than one data rank, with a model axis and without: item 6.3."""
    with pytest.raises(NotImplementedError, match=r"fsdp.*item 6\.3\)"):
        transformer.tp_axis(get_config(R.MLA_ARCH), _mesh(*shape))


# ------------------------------------------------------------ four gloo ranks


@pytest.mark.tier2
@pytest.mark.parametrize("mode", ["prefill", "decode"])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(R.TP_MLA_BLOCKS))
def test_block_meets_the_reference(ranks, name, dt, mode):
    """out and the whole latent cache over the reference's largest; the
    decode from the reference's prefill cache."""
    assert _each(ranks, f"{name}/{dt}/{mode}") <= BLOCK_TOL[dt]


@pytest.mark.tier2
def test_block_flash_prefill_meets_the_reference(ranks):
    """The bf16 prefill through K5's plain version on each rank's heads
    against the Pallas kernel in ``shard_map`` on each device's."""
    assert _each(ranks, "m2/bfloat16/flash") <= BLOCK_TOL["bfloat16"]


@pytest.mark.tier2
def test_block_gradients_meet_the_reference(ranks):
    """f32 gradients of ``sum(out · ct)``: the split leaves gathered, the
    replicated ``wkv_a`` and ``ckv_norm`` each rank's own (the same on
    every rank: ``_each``), and x."""
    assert _each(ranks, "m2/grads") <= BLOCK_TOL["float32"]


@pytest.mark.tier2
@pytest.mark.parametrize("f32", [0, 1])
def test_lm_meets_the_reference(ranks, f32):
    """The forward's, the prefill's and one decode step's logits, the
    latent caches and the greedy tokens (``check_greedy_tokens`` on each
    rank, in ``torch_ranks._tp_held``)."""
    for name in ("train_logits", "prefill_logits", "decode_logits",
                 "cache", "decode_cache"):
        assert _each(ranks, f"lm/f{f32}/{name}") <= BOUNDS[f32][0], name


@pytest.mark.tier2
@pytest.mark.parametrize("f32", [0, 1])
def test_lm_steps_meet_the_reference(ranks, f32):
    """Two ``comm='xla'`` steps at (2, 2) from the reference's inputs:
    loss, masters, momentum. In f32 every layer's expert ids are the
    reference device's; in bf16 the steps take the reference device's
    choices, and few of the port's own differ."""
    _, loss, masters, mom = BOUNDS[f32]
    d_loss, d_masters, d_mom = _each(ranks, f"lm/f{f32}/step")
    assert d_loss <= loss and d_masters <= masters and d_mom <= mom, \
        (d_loss, d_masters, d_mom)
    for r in ranks:
        routes = r[f"lm/f{f32}/routes"]
        if f32:
            assert routes.all(), routes
        else:
            assert routes[0] and routes[1] <= TIED_CHOICES, routes


@pytest.mark.tier2
def test_comm_xla_over_data_ranks_meets_the_reference(ranks):
    """Two f32 steps at (data 4, model 1) from the reference's inputs on
    its (4, 1) mesh: each rank routes and attends its own row."""
    _, loss, masters, mom = BOUNDS[1]
    d_loss, d_masters, d_mom = _each(ranks, "dp/step")
    assert d_loss <= loss and d_masters <= masters and d_mom <= mom, \
        (d_loss, d_masters, d_mom)


@pytest.mark.tier2
def test_lm_model_axis_equals_the_one_device_port(ranks):
    """In f32 at (2, 2) against the port on one device with the MoE layer
    chunked as the mesh chunks it: logits, and two steps' masters and
    momentum; the replicated masters and momentum bit-equal on every
    rank, a rank's shards its data twin's."""
    assert _each(ranks, "self/lm/logits") <= SELF_LOGITS
    assert _each(ranks, "self/lm/masters") <= SELF_STEP
    assert _each(ranks, "self/lm/mom") <= SELF_STEP
    rep = [bytes(r["self/lm/sha_rep"]) for r in ranks]
    both = [bytes(r["self/lm/sha_all"]) for r in ranks]
    assert len(set(rep)) == 1
    assert both[0] == both[2] and both[1] == both[3] and both[0] != both[1]


@pytest.mark.tier2
def test_checkpoint_and_cli(ranks):
    """The (2, 2) file equals the model-1 file key by key and loads at
    (1, 4); the CLI at --model-parallel 2 reaches run_stop on every
    rank."""
    assert bool(ranks[0]["ckpt/bytes"])
    assert all(bool(r["ckpt/elastic"]) for r in ranks)
    assert all(bool(r["cli"]) for r in ranks)
