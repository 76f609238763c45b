"""The MoE layer's experts over the model axis (ROADMAP §1 item 6.3's
first part): the expert stacks split on their expert dim, the all_to_all
body in train and prefill, the local-expert psum in decode and where S <
M, and the MoE LM under ``comm='xla'`` over several ranks. Held against
the JAX package's GSPMD program on four host devices
(``torch_reference.py tp_moe_cases``: two subprocesses at once, the
layer and the LM, the reference's MoE in ``shard_map`` under the shim on
(2, 2) and (1, 4) Auto-axis meshes) from four gloo ranks
(``torch_ranks.py lm_tp_moe``, ~8 s).

The layer (``torch_reference.TP_MOE_LAYERS``: "cap", 4 experts top-2,
whose buffers overflow on ``MOE_SKEW``'s inputs, and "pad", 20 experts
padded to 32, top-4, at (2, 2); "pad" at (1, 4), where rank 3 holds only
padded experts; "cap" at one token a row, S < M), in train and decode, f32
and bf16. Measured here: out 5.4e-7 of its max in f32 (the f32 sums of the
expert matmuls in another order), 3.9e-4 in bf16; the aux (the data
ranks' mean) 1.4e-7 relative; each rank's expert FFN buffers bit-equal to
the reference's device's (so the same choices dropped); the f32
gradients of ``sum(out · ct) + 0.01 · aux`` with respect to the params
(summed over the data ranks, gathered over ``model``) and x 6.1e-7 of
each tensor's largest, the S < M case's (the router's aux part counted
once) among them; the padded experts' gradients zero. Bounds: 1e-5 (f32)
and 3e-2 (bf16).

The LM (the reduced qwen2-moe-a2.7b at (2, 2)): the full forward over
the 32-token prompt (the reference cannot shard the 33 tokens of the
other LM tests over model 2, nor can the port), the prefill, one decode
step, the caches and the greedy tokens; two ``comm='xla'`` steps from the
reference's own inputs, every layer's expert ids equal to the reference
device's (in bf16 one token-layer of rank 0's 128 takes another expert
at a tie: its 2nd and 3rd router probabilities part by 3.6e-4, under one
bf16 ulp). Measured: bf16 logits 6.8e-3 of their max, caches
3.8e-3, one tied step; steps: loss 1.0e-4 relative, masters 3.6e-2 of the
largest update, momentum 3.6e-2; f32: logits 1.4e-6, caches 1.1e-6, loss
1.4e-7, masters 7.9e-5, momentum 1.7e-6. Bounds: ``test_torch_tp.py``'s.

Within the port, in f32: the model-axis layer against
``moe.moe_apply_chunked`` (the one-device function of the mesh's answer)
9.1e-8 of its max, the aux 6.9e-8 relative (bound 1e-6); the LM at (2, 2)
against the one-device port with the layer chunked alike: logits 1.2e-6
(bound 2e-6), two LARS steps' masters 1.4e-6 of the largest update and
momentum 9.7e-7 of its largest (bounds 1e-5); the replicated masters (the
router, the norms) bit-equal across the model ranks. ``comm='xla'`` at
(data 4, model 1): loss 1.4e-7, masters 1.4e-6 of the update against the
one-device step chunked over the rows. A MoE checkpoint saved at (2, 2)
equals the model-1 file key by key and loads at (1, 4). At no axis the
layer is bit-equal to its body before the model axis. The reduced
``--comm xla`` CLI reaches run_stop at --model-parallel 2 and at model 1
over four ranks."""
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import torch_ranks
import torch_reference as R

from repro_torch.configs import get_config
from repro_torch.launch.mesh import Axis, Mesh
from repro_torch.models import moe
from repro_torch.models import transformer
from repro_torch.models.common import local_slice
from repro_torch.models.registry import build_model

#: the layer's out, aux, buffers and gradients, by dtype
LAYER_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
#: test_torch_tp.py's: (logits and caches, loss, masters of the update,
#: momentum) in bf16 (0) and f32 (1)
BOUNDS = {1: (1e-5, 1e-6, 5e-4, 1e-5), 0: (3e-2, 4e-4, 5e-2, 5e-2)}
#: the model-axis layer against the chunked one-device function (out over
#: its max, aux relative); the LM: logits, then masters and momentum
SELF_LAYER, SELF_LOGITS, SELF_STEP = 1e-6, 2e-6, 1e-5
#: the token-layers a rank whose expert choices may differ from the
#: reference's at a bf16 tie, of the 128 of its two steps (measured: 1 on
#: rank 0, step 1, layer 1, where the two probabilities part by 3.6e-4)
TIED_CHOICES = {0: 2, 1: 0}
#: comm='xla' at (4, 1) against one device: loss relative, masters
XLA_DP_TOL = (1e-6, 1e-5)


@pytest.fixture(scope="module")
def ref_paths(tmp_path_factory):
    """The reference's two parts, in two subprocesses at once."""
    d = tmp_path_factory.mktemp("ref")
    paths = [str(d / f"tp_moe_{part}.npz") for part in R.TP_MOE_PARTS]
    with ThreadPoolExecutor(len(paths)) as pool:
        for done in [pool.submit(R.run, f"tp_moe_cases:{part}", path,
                                 devices=4)
                     for part, path in zip(R.TP_MOE_PARTS, paths)]:
            done.result()
    return ",".join(paths)


@pytest.fixture(scope="module")
def ranks(ref_paths, tmp_path_factory):
    return torch_ranks.launch(f"lm_tp_moe:{ref_paths}", 4,
                              str(tmp_path_factory.mktemp("ranks")),
                              timeout=600)


def _each(ranks, key):
    vals = [np.asarray(r[key]) for r in ranks]
    for v in vals[1:]:           # every rank gathered the same outputs
        np.testing.assert_array_equal(v, vals[0])
    return vals[0]


# ---------------------------------------------------------------- in process


def _before(p, x, cfg, *, decode):
    """The layer's body as it was before the model axis (model 1 only),
    kept here as the yardstick of the no-axis path."""
    e = cfg.moe
    B, S, d = x.shape
    T = B * S
    x_flat = x.reshape(T, d)
    gates, ids, aux = moe._route(x_flat, p["router"], e)
    E = p["w_gate"].shape[0]
    if decode:
        comb = gates.new_zeros((T, E)).scatter_add(1, ids, gates)
        h = moe._expert_ffn(p["w_gate"], p["w_up"], p["w_down"],
                            x_flat.expand(E, T, d))
        out = torch.einsum("te,etd->td", comb, h.float())
        return out.reshape(B, S, d).to(x.dtype), aux
    disp, gate_ec = moe.dispatch(ids, gates, T, E, moe.capacity(T, e))
    x_pad = torch.cat([x_flat, x_flat.new_zeros((1, d))])
    ys = moe._expert_ffn(p["w_gate"], p["w_up"], p["w_down"], x_pad[disp])
    contrib = (ys * gate_ec[..., None]).reshape(-1, d)
    out = moe._combine(contrib, disp, ids, T)
    return out.reshape(B, S, d).to(x.dtype), aux


@pytest.mark.tier1
@pytest.mark.parametrize("mode", ["train", "decode"])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(R.MOE_CASES))
def test_no_axis_layer_is_bit_equal_to_its_body_before(case, dt, mode):
    """``tp=None`` computes what the layer computed before the model
    axis, bit for bit: out, aux and the gradients (``test_torch_moe.py``
    holds it against the reference); so does ``moe_apply_chunked`` at one
    chunk."""
    cfg = R.moe_case_cfg(get_config, case)
    gen = torch.Generator().manual_seed(3)
    dtype = getattr(torch, dt)
    pd = moe.moe_pd(cfg)
    p = {k: (0.05 * torch.randn(v.shape, generator=gen)).to(dtype)
         for k, v in pd.items()}
    x = (torch.randn(R.MOE_B, R.MOE_S, cfg.d_model, generator=gen)
         + R.MOE_SKEW * torch.randn(cfg.d_model, generator=gen)).to(dtype)
    decode = mode == "decode"
    runs = []
    # x's gradient sums the dispatch gather's rows with an accumulating
    # index_put, whose order varies between runs unless deterministic
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        for fn in (moe.moe_apply, _before):
            leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
            xg = x.clone().requires_grad_()
            o, a = fn(leaves, xg, cfg, decode=decode)
            (o.float().sum() + a).backward()
            runs.append([o, a, xg.grad, *(v.grad for v in leaves.values())])
    finally:
        torch.use_deterministic_algorithms(was)
    for a, b in zip(*runs):
        assert a.dtype == b.dtype and torch.equal(a, b)
    o, a = moe.moe_apply_chunked(p, x, cfg, decode=decode)
    assert torch.equal(o, runs[1][0]) and torch.equal(a, runs[1][1])


def _mesh(data: int, model: int) -> Mesh:
    """A (data, model) mesh seen from rank 0, with no process groups: a
    collective on it would fail."""
    return Mesh((Axis("data", data, 0, tuple(range(0, data * model, model)),
                      None),
                 Axis("model", model, 0, tuple(range(model)), None)),
                torch.device("cpu"))


@pytest.mark.tier1
@pytest.mark.parametrize("entry", ["train", "prefill", "generate"])
def test_a_length_the_axis_does_not_divide_is_refused(entry):
    """33 tokens over model 2 (train, prefill, the serving loop): the
    reference cannot shard that length either; raised before any
    collective (the mesh has no process groups). One token (S < M) is the
    local-psum branch and needs no split."""
    from repro_torch.serve.decode import generate
    cfg = get_config(R.MOE_ARCH).reduced()
    model = build_model(cfg)
    mesh = _mesh(1, 2)
    toks = torch.zeros((2, 33), dtype=torch.int32)
    calls = {"train": lambda: model.forward_train({}, {"tokens": toks},
                                                  mesh=mesh),
             "prefill": lambda: model.forward_prefill({}, {"tokens": toks},
                                                      40, mesh),
             "generate": lambda: generate(model, {}, {"tokens": toks},
                                          max_new=2, cache_len=40,
                                          mesh=mesh)}
    with pytest.raises(NotImplementedError,
                       match="cannot shard a length that 2 does not"):
        calls[entry]()
    transformer._check_tokens(cfg, mesh.axis("model"), 1)
    transformer._check_tokens(cfg, mesh.axis("model"), 32)


@pytest.mark.tier1
@pytest.mark.parametrize("m,stack", [(2, 32), (4, 32), (16, 64)])
def test_expert_stacks_split_on_their_expert_dim(m, stack):
    """The padded stack (20 -> 32; the full qwen2-moe-a2.7b's 60 -> 64)
    splits evenly over model ``m``; the router stays whole; a stack ``m``
    does not divide (the reduced 4 experts over 8) is an uneven split."""
    base = get_config(R.MOE_ARCH)
    cfg = (dataclasses.replace(base.reduced(), moe=dataclasses.replace(
        base.reduced().moe, n_routed=20)) if stack == 32 else base)
    assert moe.padded_experts(cfg) == stack
    pd = moe.moe_pd(cfg)
    axis = Mesh((Axis("model", m, m - 1, tuple(range(m)), None),),
                torch.device("cpu")).axis("model")
    assert local_slice(pd["router"], axis) == (None, 0, 0)
    for k in ("w_gate", "w_up", "w_down"):
        assert local_slice(pd[k], axis) == (0, (m - 1) * stack // m,
                                            stack // m)
    with pytest.raises(NotImplementedError, match="cannot place either"):
        transformer.tp_axis(get_config(R.MOE_ARCH).reduced(), _mesh(1, 8))


# ------------------------------------------------------------ four gloo ranks


@pytest.mark.tier2
@pytest.mark.parametrize("mode", ["train", "decode"])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(R.TP_MOE_LAYERS))
def test_layer_meets_the_reference(ranks, name, dt, mode):
    """out and aux over the reference's; in train each rank's expert FFN
    buffers (the all_to_all's (E/M, M·C, d), or S < M's broadcast)."""
    tol = LAYER_TOL[dt]
    key = f"{name}/{dt}/{mode}"
    assert _each(ranks, f"{key}/out") <= tol
    assert _each(ranks, f"{key}/aux") <= tol
    if mode == "train":
        for r in ranks:          # each rank's own buffers
            assert float(r[f"{key}/xs"]) <= tol


@pytest.mark.tier2
@pytest.mark.parametrize("name", list(R.TP_MOE_LAYERS))
def test_layer_gradients_meet_the_reference(ranks, name):
    """f32 gradients of ``sum(out · ct) + 0.01 · aux`` (params and x);
    the padded experts' are zero."""
    assert _each(ranks, f"{name}/float32/train/grads") <= LAYER_TOL[
        "float32"]
    assert bool(_each(ranks, f"{name}/float32/train/dead"))


@pytest.mark.tier2
@pytest.mark.parametrize("mode", ["train", "decode"])
@pytest.mark.parametrize("name", list(R.TP_MOE_LAYERS))
def test_layer_equals_the_chunked_plain_function(ranks, name, mode):
    """The mesh's layer against ``moe_apply_chunked`` on one device: out
    over its max, aux relative."""
    d_out, d_aux = _each(ranks, f"self/{name}/{mode}")
    assert d_out <= SELF_LAYER and d_aux <= SELF_LAYER


@pytest.mark.tier2
@pytest.mark.parametrize("f32", [0, 1])
def test_lm_meets_the_reference(ranks, f32):
    """The forward's, the prefill's and one decode step's logits, the
    caches and the greedy tokens (``check_greedy_tokens`` on each rank)."""
    for name in ("train_logits", "prefill_logits", "decode_logits",
                 "cache", "decode_cache"):
        assert _each(ranks, f"lm/f{f32}/{name}") <= BOUNDS[f32][0], name


@pytest.mark.tier2
@pytest.mark.parametrize("f32", [0, 1])
def test_lm_steps_meet_the_reference(ranks, f32):
    """Two ``comm='xla'`` steps from the reference's inputs: loss,
    masters, momentum; every layer's expert ids each rank's device's, in
    f32 bit for bit, in bf16 but at a tie (the choice's k-th and (k+1)-th
    probabilities within one bf16 ulp of the k-th)."""
    _, loss, masters, mom = BOUNDS[f32]
    d_loss, d_masters, d_mom = _each(ranks, f"lm/f{f32}/step")
    assert d_loss <= loss and d_masters <= masters and d_mom <= mom, \
        (d_loss, d_masters, d_mom)
    for r in ranks:
        layers, ties, flips = r[f"lm/f{f32}/routes"]
        assert layers and ties and flips <= TIED_CHOICES[f32], flips


@pytest.mark.tier2
def test_lm_model_axis_equals_the_chunked_one_device_port(ranks):
    """In f32 at (2, 2) against the port on one device with the layer
    chunked as the mesh chunks it: logits, and two steps' masters and
    momentum; the replicated masters and momentum (the router, the norms)
    bit-equal on every rank, a rank's shards its data twin's."""
    assert _each(ranks, "self/lm/logits") <= SELF_LOGITS
    assert _each(ranks, "self/lm/masters") <= SELF_STEP
    assert _each(ranks, "self/lm/mom") <= SELF_STEP
    rep = [bytes(r["self/lm/sha_rep"]) for r in ranks]
    both = [bytes(r["self/lm/sha_all"]) for r in ranks]
    assert len(set(rep)) == 1
    assert both[0] == both[2] and both[1] == both[3] and both[0] != both[1]


@pytest.mark.tier2
def test_comm_xla_over_data_ranks_routes_each_ranks_rows(ranks):
    """(data 4, model 1): each rank routes its own row with its own
    capacity, as the reference's shard_map does; against the one-device
    step chunked over the rows."""
    d_loss, d_masters = _each(ranks, "xla_dp")
    assert d_loss <= XLA_DP_TOL[0] and d_masters <= XLA_DP_TOL[1]


@pytest.mark.tier2
def test_checkpoint_and_cli(ranks):
    """The (2, 2) file equals the model-1 file key by key and loads at
    (1, 4); the CLI at --model-parallel 2 and at model 1 reaches
    run_stop on every rank."""
    assert bool(ranks[0]["ckpt/bytes"])
    assert all(bool(r["ckpt/elastic"]) for r in ranks)
    assert all(bool(r["cli"]) for r in ranks)
