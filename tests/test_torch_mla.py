"""The port's MLA (``models/attention.py``: ``mla_pd``, ``mla_parallel``,
``mla_decode``, ``mla_decode_inplace``) and the MLA MoE LM (reduced
deepseek-v2-236b: 2 layers, d 256, 4 heads, kv_lora 64, rope 16, nope
32, v 32, 4 routed experts top-2, 1 shared, vocab 512) against the JAX
package's, on the reference's own numpy inputs (``tests/torch_reference.py
mla_cases``: one subprocess; the module cases with ``mesh=None``, the MoE
layer and the LM on a (1, 1) Auto-axis mesh under the shard_map shim, XLA
rounding at every bf16 operation). Also ``gqa_decode_inplace``, the GQA
counterpart of ``mla_decode_inplace``.

The module: ``mla_parallel``'s output agrees to 1e-5 of its max in f32
(measured 5.1e-7, chunked and flash) and to one bf16 ulp of its max in
bf16 (measured 6.9e-4 of the max); its latent cache to 1e-6 of its max in
f32 (measured 6.0e-7: the projection's f32 sums in another order) and
element by element within one bf16 ulp in bf16, where a bf16 matmul's
summation order could flip a rounding (measured: all 6,400 elements
equal). The absorbed decode, from the reference's cache, in place and
not, at the same bounds (measured 6.0e-7 in f32, equal in bf16); it
equals the explicit attention over the decompressed cache to 1e-5 in
f32. ``gqa_decode_inplace`` likewise (measured 8.0e-7 and 4.4e-7 in f32,
equal in bf16 but one element of a new v row, one ulp apart).

The family at ``test_torch_moe.py``'s bounds, flash off and on: the MoE
layer's routing ids and dispatched buffers bit-equal (10 choices
dropped), logits (measured 7.5e-3 and 4.2e-3 of their max), prefill
(4.8e-3 and 0), caches (4.4e-3 and 9.7e-4, at most 0.8% of elements
differing), decode from the reference's cache (equal), greedy tokens
(equal, no tie), the decode against the port's own full forward at
capacity factor 16 (1.1e-2 and 1.2e-2), and two ``comm='xla'`` training
steps on the reference's expert choices (loss 4.2e-5 and 9.9e-5
relative, params 5.1e-5 of their max)."""
import dataclasses
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
import torch_reference as R

from repro.configs import get_config as jget_config
from repro.configs import param_count as jparam_count
from repro.configs.base import active_param_count as jactive_param_count
from repro.models import attention as jattn
from repro.models import transformer as jtf
from repro_torch import weights
from repro_torch.configs import active_param_count, get_config, param_count
from repro_torch.core import lars, pinit
from repro_torch.core.schedule import ScheduleConfig, make_schedule
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import attention as attn
from repro_torch.models import moe
from repro_torch.models import transformer as ttf
from repro_torch.models.registry import build_model
from repro_torch.serve.decode import generate
from repro_torch.train.step import make_train_step
from repro_torch.tree import tree_flatten

pytestmark = pytest.mark.tier1

#: module outputs in f32: the f32 sums of the matmuls in another order
OUT_TOL_F32 = 1e-5
#: the f32 latent cache: the projection's f32 sums in another order
CACHE_TOL_F32 = 1e-6
#: the absorbed decode against the explicit attention over the
#: decompressed cache (f32): the same sums associated otherwise
ABSORBED_TOL = 1e-5
#: test_torch_moe.py's (and test_torch_lm.py's) bounds
LOGIT_TOL = 2e-2
CACHE_DIFFER_FRAC = 0.05
DECODE_TOL = 1e-3
SELF_DECODE_TOL = 3e-2
LM_AUX_RTOL = 1e-4
LOSS_RTOL = 4e-4
UPDATE_WORST, UPDATE_MEDIAN = 0.1, 0.04
PARAM_TOL = 2e-4
P, C, NEW = R.LM_PROMPT, R.LM_CACHE, R.LM_NEW
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = ["float32", "bfloat16"]


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: the suite runs six workers on the CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(2, before))
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return R.run("mla_cases", str(tmp_path_factory.mktemp("ref") /
                                  "mla.npz"))


@pytest.fixture(scope="module")
def base():
    return get_config(R.MLA_ARCH).reduced()


@pytest.fixture(scope="module")
def params(ref, base):
    return weights.lm_params_from_jax(ref["params"], base, "cpu")


@pytest.fixture(scope="module")
def tokens(base):
    return torch.from_numpy(R.lm_tokens(base))


def _t(x, dt):
    return torch.from_numpy(np.ascontiguousarray(x)).to(getattr(torch, dt))


def _rel(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    return float(np.abs(got - want).max() / np.abs(want).max())


def _bf16_ulp(x):
    """One bf16 ulp at each |x| (8 significant bits); 2^-133 at 0."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 1e-38))) - 7)


def _jflat(tree):
    import jax
    is_pd = lambda x: hasattr(x, "init")
    leaves = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_pd)[0]
    return {"/".join(k.key for k in path): pd for path, pd in leaves}


# ---------------------------------------------------------------------------
# the config and the descriptors


def test_config_and_param_counts_equal_the_reference():
    """Field for field, full and reduced; ``param_count`` (244.19 B) and
    ``active_param_count`` as the reference counts them."""
    got, want = get_config(R.MLA_ARCH), jget_config(R.MLA_ARCH)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(got.reduced()) == \
        dataclasses.asdict(want.reduced())
    assert param_count(got) == jparam_count(want) == 244_187_791_360
    assert active_param_count(got) == jactive_param_count(want)
    cut = dataclasses.replace(got, n_layers=4)
    assert param_count(cut) == jparam_count(dataclasses.replace(
        want, n_layers=4))


@pytest.mark.parametrize("which", ["mla_pd", "lm_pd", "cache_pd"])
@pytest.mark.parametrize("reduced", [True, False])
def test_descriptors_equal_the_reference(which, reduced):
    """Paths, shapes, initializers, scales and dtypes: the MLA block's
    (wo's scale from n_layers), the whole LM's, and the latent cache's."""
    cfg, jcfg = get_config(R.MLA_ARCH), jget_config(R.MLA_ARCH)
    if reduced:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    got, want = {
        "mla_pd": lambda: (attn.mla_pd(cfg), jattn.mla_pd(jcfg)),
        "lm_pd": lambda: (ttf.lm_pd(cfg), jtf.lm_pd(jcfg)),
        "cache_pd": lambda: (ttf.cache_pd(cfg, 8, 2088),
                             jtf.cache_pd(jcfg, 8, 2088))}[which]()
    got, want = dict(tree_flatten(got)), _jflat(want)
    assert list(got) == sorted(want)
    for path, pd in got.items():
        w = want[path]
        assert (pd.shape, pd.init, pd.scale) == (w.shape, w.init,
                                                 w.scale), path
        assert str(pd.dtype).split(".")[-1] == str(np.dtype(w.dtype))
    if which == "cache_pd":
        assert sorted(got) == ["ckv", "krope"]


def test_weights_refuse_a_wrong_shaped_mla_leaf(base, ref):
    """``lm_params_from_jax`` carries the MLA tree across and refuses a
    wk_b of the wrong rank; ``cache_from_jax`` refuses a GQA-shaped
    cache for an MLA model."""
    tree = {k: v for k, v in ref["params"].items()}
    got = weights.lm_params_from_jax(tree, base, "cpu")
    np.testing.assert_array_equal(got["layers"]["attn"]["wk_b"].numpy(),
                                  tree["layers"]["attn"]["wk_b"])
    layers = dict(tree["layers"], attn=dict(tree["layers"]["attn"]))
    layers["attn"]["wk_b"] = layers["attn"]["wk_b"][:, :32]
    with pytest.raises(ValueError, match="wk_b"):
        weights.lm_params_from_jax(dict(tree, layers=layers), base, "cpu")
    gqa = {n: np.zeros((base.n_layers, 2, C, base.n_heads, 64), np.float32)
           for n in ("k", "v")}
    with pytest.raises(ValueError, match="paths differ"):
        weights.cache_from_jax(gqa, base, 2, C, "cpu")


# ---------------------------------------------------------------------------
# the module


def _mla_params(ref, dt):
    return {n: _t(v, dt) for n, v in ref["mla"]["params"].items()}


def _mla_cfg(base, flash=0):
    return dataclasses.replace(base, flash_attention=bool(flash))


def _assert_out(got, want, dt):
    """f32: within OUT_TOL_F32 of the max; bf16: within one bf16 ulp of
    the max (the output's own rounding)."""
    err = np.abs(got.float().numpy() - want).max()
    peak = np.abs(want).max()
    assert err <= (OUT_TOL_F32 * peak if dt == "float32"
                   else float(_bf16_ulp(peak))), (err, peak)


def _assert_rows(got, want, dt, what):
    """Cache rows: f32 within CACHE_TOL_F32 of their max; bf16 each
    element within one bf16 ulp of the reference's."""
    if dt == "float32":
        assert _rel(got, want) <= CACHE_TOL_F32, what
    else:
        diff = np.abs(got.float().numpy() - want)
        assert (diff <= _bf16_ulp(want)).all(), what


@pytest.mark.parametrize("flash", [0, 1])
@pytest.mark.parametrize("dt", DTYPES)
def test_mla_parallel_matches_reference(ref, base, dt, flash):
    """The output (chunked: the port's chunked path; flash: K5's plain
    version against the Pallas kernel in interpret mode) and the latent
    cache (``_assert_out``, ``_assert_rows``)."""
    cfg = _mla_cfg(base, flash)
    p, x = _mla_params(ref, dt), _t(ref["mla"]["x"], dt)
    positions = torch.arange(P)[None]
    out, cache = attn.mla_parallel(p, x, positions, cfg, cache_len=C)
    want = ref["mla"][dt][f"f{flash}"]
    assert out.dtype == x.dtype and out.shape == (R.LM_BATCH, P,
                                                  cfg.d_model)
    _assert_out(out, want["out"], dt)
    m = cfg.mla
    for name, width in (("ckv", m.kv_lora_rank), ("krope", m.rope_head_dim)):
        got = cache[name]
        assert got.dtype == x.dtype and got.shape == (R.LM_BATCH, C, width)
        assert not got[:, P:].any()
        _assert_rows(got, want["cache"][name], dt, name)


def _decode_cache(ref, dt):
    return {n: _t(v, dt).clone() for n, v in
            ref["mla"][dt]["f0"]["cache"].items()}


@pytest.mark.parametrize("dt", DTYPES)
def test_mla_decode_matches_reference(ref, base, dt):
    """One absorbed step from the reference's own cache: the new row
    written in place (``_assert_rows``), the rest untouched, the output
    (``_assert_out``)."""
    p, xd = _mla_params(ref, dt), _t(ref["mla"]["x_dec"], dt)
    cache = _decode_cache(ref, dt)
    before = {n: t.clone() for n, t in cache.items()}
    out, got = attn.mla_decode(p, xd, P, base, cache)
    assert got is cache
    want = ref["mla"][dt]["decode"]
    _assert_out(out, want["out"], dt)
    rows = [i for i in range(C) if i != P]
    for name in ("ckv", "krope"):
        assert torch.equal(cache[name][:, rows], before[name][:, rows])
        _assert_rows(cache[name][:, P], want["cache"][name][:, P], dt, name)


@pytest.mark.parametrize("dt", DTYPES)
def test_mla_decode_inplace_matches_reference(ref, base, dt):
    """The stacked (L, B, Smax, ·) latent caches: layer MLA_LAYER's row P
    written in place, every other element untouched, the output as
    ``mla_decode``'s from that layer's cache, bit for bit."""
    p, xd = _mla_params(ref, dt), _t(ref["mla"]["x_dec"], dt)
    r = ref["mla"][dt]["inplace"]
    ckv_all, kr_all = _t(r["in"]["ckv"], dt), _t(r["in"]["krope"], dt)
    before = (ckv_all.clone(), kr_all.clone())
    out, a, b = attn.mla_decode_inplace(p, xd, P, base, ckv_all, kr_all,
                                        R.MLA_LAYER)
    assert a is ckv_all and b is kr_all
    _assert_out(out, r["out"]["out"], dt)
    for got, old, name in ((a, before[0], "ckv"), (b, before[1], "krope")):
        changed = (got != old).nonzero()
        assert bool((changed[:, 0] == R.MLA_LAYER).all()
                    and (changed[:, 2] == P).all()), name
        _assert_rows(got[R.MLA_LAYER, :, P], r["out"][name][R.MLA_LAYER, :, P],
                     dt, name)
    layer = {"ckv": before[0][R.MLA_LAYER].clone(),
             "krope": before[1][R.MLA_LAYER].clone()}
    alone, _ = attn.mla_decode(p, xd, P, base, layer)
    assert torch.equal(alone, out)
    assert torch.equal(layer["ckv"], a[R.MLA_LAYER])


def test_absorbed_decode_equals_explicit_attention(ref, base):
    """Port only, f32: the absorbed step (W^UK folded into the query, W^UV
    applied to the attended latent) against attention over keys and values
    decompressed from the same cache (k = [ckv W^UK, krope], v = ckv
    W^UV, q = [q_nope, rope(q_rope)]), within 1e-5 of the output's max."""
    m, H = base.mla, base.n_heads
    p, xd = _mla_params(ref, "float32"), _t(ref["mla"]["x_dec"], "float32")
    cache = _decode_cache(ref, "float32")
    out, _ = attn.mla_decode(p, xd, P, base, cache)
    ckv, kr = cache["ckv"][:, :P + 1], cache["krope"][:, :P + 1]
    B, S = ckv.shape[:2]
    pp = torch.full((B, 1), P)
    q_nope, q_rope = attn._mla_q(p, xd, pp, base)
    k = torch.cat([(ckv @ p["wk_b"]).reshape(B, S, H, m.nope_head_dim),
                   kr[:, :, None].expand(B, S, H, m.rope_head_dim)], -1)
    v = (ckv @ p["wv_b"]).reshape(B, S, H, m.v_head_dim)
    q = torch.cat([q_nope, q_rope], -1)[:, 0]
    s = torch.einsum("bhd,bshd->bhs", q, k) \
        * (m.nope_head_dim + m.rope_head_dim) ** -0.5
    o = torch.einsum("bhs,bshv->bhv", torch.softmax(s, -1), v)
    want = o.reshape(B, 1, -1) @ p["wo"]
    err = float((out - want).abs().max() / want.abs().max())
    assert err < ABSORBED_TOL, err


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("arch", R.GQA_INPLACE_ARCHS)
def test_gqa_decode_inplace_matches_reference(ref, arch, dt):
    """GQA's in-place decode into stacked (L, B, Smax, K, Dh) caches:
    the output (``_assert_out``), the new rows (``_assert_rows``), every
    other element untouched, and ``gqa_decode`` on that layer's cache
    bit-equal."""
    cfg = get_config(arch).reduced()
    r = ref["gqa"][arch]
    p = {n: _t(v, dt) for n, v in r["params"].items()}
    x = _t(r["x"], dt)
    ck, cv = _t(r["k"], dt), _t(r["v"], dt)
    before = (ck.clone(), cv.clone())
    out, a, b = attn.gqa_decode_inplace(p, x, P, cfg, ck, cv, R.MLA_LAYER)
    assert a is ck and b is cv
    _assert_out(out, r[dt]["out"], dt)
    for got, old, name in ((a, before[0], "k"), (b, before[1], "v")):
        changed = (got != old).nonzero()
        assert bool((changed[:, 0] == R.MLA_LAYER).all()
                    and (changed[:, 2] == P).all()), name
        _assert_rows(got[R.MLA_LAYER, :, P], r[dt][name][R.MLA_LAYER, :, P],
                     dt, name)
    layer = {"k": before[0][R.MLA_LAYER].clone(),
             "v": before[1][R.MLA_LAYER].clone()}
    alone, _ = attn.gqa_decode(p, x, P, cfg, layer)
    assert torch.equal(alone, out)
    assert torch.equal(layer["k"], a[R.MLA_LAYER])


def test_decode_refuses_a_position_outside_the_cache(ref, base):
    p, xd = _mla_params(ref, "float32"), _t(ref["mla"]["x_dec"], "float32")
    with pytest.raises(ValueError, match="outside the cache"):
        attn.mla_decode(p, xd, C, base, _decode_cache(ref, "float32"))


# ---------------------------------------------------------------------------
# the MoE layer at the reduced MLA config


@pytest.mark.parametrize("dt", DTYPES)
def test_moe_routing_and_dispatch_match_reference(ref, base, dt):
    """``models/moe.py`` unchanged at deepseek's reduced routing (4
    experts, top-2, 1 shared): routing ids bit-equal, the dispatched
    (E, C, d) buffers bit-equal (the same choices dropped: at least one),
    the output within 1e-6 of its max in f32 and one bf16 ulp in bf16."""
    r = ref["moe"]
    p = {n: _t(v, dt) for n, v in r["params"].items()}
    x = _t(r["x"], dt)
    T, d = x.shape[0] * x.shape[1], base.d_model
    gates, ids, _ = moe._route(x.reshape(T, d), p["router"], base.moe)
    np.testing.assert_array_equal(ids.numpy(), r[dt]["route"]["ids"])
    disp, _ = moe.dispatch(ids, gates, T, p["w_gate"].shape[0],
                           moe.capacity(T, base.moe))
    xs = torch.cat([x.reshape(T, d), x.new_zeros((1, d))])[disp]
    np.testing.assert_array_equal(xs.float().numpy(), r[dt]["train"]["xs"])
    dropped = T * base.moe.top_k - int((disp < T).sum())
    assert dropped > 0
    out, _ = moe.moe_apply(p, x, base, decode=False)
    want = r[dt]["train"]["out"]
    err = np.abs(out.float().numpy() - want).max()
    peak = np.abs(want).max()
    assert err <= (1e-6 * peak if dt == "float32"
                   else float(_bf16_ulp(peak))), err


# ---------------------------------------------------------------------------
# the MLA LM


def _model(base, flash):
    return build_model(dataclasses.replace(base, flash_attention=bool(flash)))


@pytest.mark.parametrize("flash", [0, 1])
def test_forward_train_matches_reference(ref, base, params, tokens, flash):
    (logits, aux), _ = _model(base, flash).forward_train(
        params, {"tokens": tokens})
    want = ref[f"f{flash}"]
    assert logits.dtype == torch.float32
    assert _rel(logits, want["train_logits"]) < LOGIT_TOL
    assert aux.dtype == torch.float32 and float(aux) > 0
    np.testing.assert_allclose(float(aux), float(want["train_aux"]),
                               rtol=LM_AUX_RTOL)


@pytest.mark.parametrize("flash", [0, 1])
def test_prefill_and_decode_match_reference(ref, base, params, tokens,
                                            flash):
    """The prefill's last logits and latent cache, and one absorbed
    decode step from the reference's own cache (carried by
    ``cache_from_jax``)."""
    model = _model(base, flash)
    before = fa.flash_attention.launches
    last, cache = model.forward_prefill(params, {"tokens": tokens[:, :P]},
                                        C)
    assert fa.flash_attention.launches == before    # CPU: no kernel
    r = ref[f"f{flash}"]
    assert _rel(last, r["prefill_logits"]) < LOGIT_TOL
    assert sorted(cache) == ["ckv", "krope"]
    for name in cache:
        got, want = cache[name], r["cache"][name]
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        assert _rel(got, want) < LOGIT_TOL, name
        assert (got.float().numpy() != want).mean() < CACHE_DIFFER_FRAC
    cache = weights.cache_from_jax(r["cache"], model.cfg, R.LM_BATCH, C,
                                   "cpu")
    logits, _ = model.forward_decode(params, cache, tokens[:, P:], P)
    assert _rel(logits, r["decode_logits"]) < DECODE_TOL
    for name in cache:
        assert _rel(cache[name][:, :, P], r["decode_cache"][name][:, :, P]) \
            < DECODE_TOL


@pytest.mark.parametrize("flash", [0, 1])
def test_decode_matches_own_full_forward(base, params, tokens, flash):
    """As ``test_serve.py``: with capacity_factor 16 (the full forward
    drops no token, and decode never drops), prefill + one absorbed
    decode step == the (non-absorbed) full forward's next position."""
    cfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, capacity_factor=16.0))
    model = _model(cfg, flash)
    (full, _), _ = model.forward_train(params, {"tokens": tokens})
    _, cache = model.forward_prefill(params, {"tokens": tokens[:, :P]}, C)
    dl, _ = model.forward_decode(params, cache, tokens[:, P:], P)
    assert _rel(dl[:, 0], full[:, -1].numpy()) < SELF_DECODE_TOL


@pytest.mark.parametrize("flash", [0, 1])
def test_generate_matches_reference_tokens(ref, base, params, tokens, flash):
    """Greedy tokens equal the reference's up to a tie at bf16 resolution
    (``torch_reference.check_greedy_tokens``)."""
    model = _model(base, flash)
    out = generate(model, params, {"tokens": tokens[:, :P]}, max_new=NEW,
                   cache_len=C)
    assert out.dtype == torch.int32 and out.shape == (R.LM_BATCH, NEW)
    R.check_greedy_tokens(model, params, tokens[:, :P], ref[f"f{flash}"][
        "generate"], out.numpy(), C)


def _relnorm(got, want):
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


class _PinnedRoutes:
    """While active, each MoE layer of the port takes the given (T, k)
    expert ids, in layer order, in place of its own top-k (the gates are
    still its own probabilities at those ids), and counts the token-layers
    whose own choice differs."""

    def __init__(self, ids):
        self.ids, self.flips, self.real = list(ids), 0, moe._top_k

    def __enter__(self):
        def top_k(x, k):
            own = self.real(x, k)[1]
            want = torch.from_numpy(self.ids.pop(0)).long()
            self.flips += int((own.sort(-1).values != want.sort(-1).values)
                              .any(-1).sum())
            return x.gather(-1, want), want
        moe._top_k = top_k
        return self

    def __exit__(self, *exc):
        moe._top_k = self.real


@pytest.mark.parametrize("k", range(R.MOE_TRAIN_STEPS))
def test_train_step_matches_reference(ref, base, k):
    """``comm='xla'`` steps from the reference's own states: the loss
    with ``0.01 · aux`` in it, the aux, the new params and momentum
    (every MLA leaf, expert and router). The port's forward takes the
    reference's expert choices (``train/s{k}/route``): a choice whose
    k-th and (k+1)-th probabilities tie within the two packages' bf16
    rounding could go either way, and one flipped choice moves the aux
    and that expert's gradient. Measured: no flip at step 0; at step 1 the
    port's own choice differs in one token-layer (its probabilities 7.8e-5
    apart; unpinned, that expert's w_up lands 1.2e-3 of its max away).
    Pinned: the loss within 4.2e-5 and 9.9e-5 relative, the aux 4.4e-7 and
    5.2e-5, updates 1.1e-2 worst, params 5.1e-5 of their max."""
    r = ref["train"][f"s{k}"]
    step = make_train_step(build_model(base), lars.OptConfig(kind="lars"),
                           make_schedule(ScheduleConfig(**R.LR)),
                           comm="xla")
    state_in = weights.lm_state_from_jax(types.SimpleNamespace(**r["in"]),
                                         base, "cpu")
    batch = {n: torch.from_numpy(v) for n, v in r["batch"].items()}
    routes = [r["route"][f"l{i}"] for i in range(base.n_layers)]
    with _PinnedRoutes(routes) as pin:
        state, metrics = step(state_in, batch)
    assert not pin.ids and pin.flips <= 1
    assert state.step == int(r["out"]["step"]) == k + 1
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(r["metrics"]["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(metrics["aux"]),
                               float(r["metrics"]["aux"]), rtol=LM_AUX_RTOL)
    p_in = dict(tree_flatten(weights.to_numpy(state_in.params)))
    got_p = dict(tree_flatten(weights.to_numpy(state.params)))
    got_m = dict(tree_flatten(weights.to_numpy(state.mom)))
    want_p = dict(tree_flatten(r["out"]["params"]))
    want_m = dict(tree_flatten(r["out"]["mom"]))
    assert set(got_p) == set(want_p)
    assert any("wkv_a" in n for n in want_p)
    upd = [_relnorm(got_p[n] - p_in[n], want_p[n] - p_in[n])
           for n in want_p]
    mom = [_relnorm(got_m[n], want_m[n]) for n in want_m]
    assert max(upd) < UPDATE_WORST and np.median(upd) < UPDATE_MEDIAN
    assert max(mom) < UPDATE_WORST and np.median(mom) < UPDATE_MEDIAN
    for n in want_p:
        d = np.abs(got_p[n] - want_p[n]).max() / np.abs(want_p[n]).max()
        assert d < PARAM_TOL, (n, d)


# ---------------------------------------------------------------------------
# serving's bf16 weights and the CLI


def test_pinit_bf16_leaves_equal_the_cast(base):
    """Each bf16 leaf pinit makes equals the cast of its f32 leaf."""
    pd = build_model(base).param_pd
    f32 = dict(tree_flatten(pinit.materialize(pd, 7, "cpu")))
    b16 = pinit.materialize(pd, 7, "cpu", dtype=torch.bfloat16)
    for path, leaf in tree_flatten(b16):
        assert leaf.dtype == torch.bfloat16, path
        assert torch.equal(leaf, f32[path].to(torch.bfloat16)), path


def test_profile_depth_cut(capsys):
    """``profile_serve.py --layers`` cuts the depth (printed), keeps the
    width and refuses a count the model does not have."""
    from repro_torch.launch.profile_serve import cut_depth
    cfg = get_config(R.MLA_ARCH)
    cut = cut_depth(cfg, 4)
    assert cut.n_layers == 4 and cut.d_model == cfg.d_model
    assert "depth cut to 4 of its 60 layers" in capsys.readouterr().out
    assert cut_depth(cfg, None) is cfg
    with pytest.raises(ValueError, match="has 60 layers"):
        cut_depth(cfg, 61)


def test_serve_cli_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.serve.decode", "--arch",
         R.MLA_ARCH, "--reduced", "--device", "cpu", "--batch", "2",
         "--max-new", "4", "--flash-attention"], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    assert out.returncode == 0, out.stderr
    assert f"arch={R.MLA_ARCH} (reduced)" in out.stdout
    assert "generated (2, 4) tokens" in out.stdout
