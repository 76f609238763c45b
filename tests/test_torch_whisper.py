"""The port's whisper pieces (``models/common.layer_norm``,
``models/mlp.gelu_mlp_*``, cross-attention in ``models/attention.py``) and
the whisper LM (the reduced whisper-base: d 256, 4 heads of 64, 2 decoder
and 2 encoder layers over 16 stub frames, d_ff 512, vocab 512, learned
positions, no rope) against the JAX package's, on the reference's own
numpy inputs (``tests/torch_reference.py whisper_cases``: one subprocess,
``mesh=None``, XLA rounding at every bf16 operation).

The pieces, in f32 and bf16: ``layer_norm`` bit for bit in bf16 (its f32
sums land on the same bf16 values) and within 1e-6 of the max in f32
(measured 2.3e-7); the GELU MLP within 1e-5 in f32 (measured 1.1e-6) and
in bf16 at most 0.1% of the elements apart (measured 0.012%: the bf16
matmuls' summation order flips a rounding), within 1e-2 of the max
(measured 1.5e-3); cross-attention, ``gqa_parallel(..., cross_x=)``
(non-causal, 33 queries over 16 encoder states) with ``flash_attention``
False and True (K5's plain version here, the Pallas kernel in interpret
mode there) and its cache, in f32 within 1e-5 (measured 6.2e-7) and in
bf16 within 1e-2 (measured 2.7e-3); ``gqa_decode(..., cross=True)`` from
the reference's cache within 1e-5 in f32 and equal in bf16.

The LM. Wholly in f32 (``precision.f32_compute``; the reference's bf16
casts of the frames and position tables read as f32 there,
``torch_reference._F32Numpy``): logits within 1e-5 of their max and each
leaf's gradient within 1e-5 of its own largest (measured 7.7e-7 and
3.1e-6, ``layers/lnx``). In bf16, flash off and on: logits and the
prefill's last logits within 1e-2 (measured 5.7e-3 and 6.7e-3), the
caches (``self`` and ``cross``, bf16) within 1e-2 of their max (the
encoder's output rounds apart in up to 32% of its elements by one ulp, so
no share of equal elements is held); one decode step from the
reference's cache within 1e-3 (measured 0: the step's roundings agree);
decode against the port's own full forward within 3e-2
(``tests/test_serve.py``'s bound; measured 6.3e-3 and 4.2e-3); greedy
tokens equal up to a bf16 tie; two ``comm='xla'`` training steps from the
reference's states: the loss within 4e-4 relative (measured 2.2e-6 and
4.3e-5), each tensor's new params within 5e-2 of its largest update and
its momentum of its largest (measured 2.2e-2 and 1.7e-2)."""
import dataclasses

import numpy as np
import pytest
import torch
import torch_reference as R

from repro.configs import get_config as jget_config
from repro.configs import param_count as jparam_count
from repro.models import transformer as jtf
from repro_torch import weights
from repro_torch.configs import get_config, param_count
from repro_torch.data.synthetic import stub_frames, token_batch
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlpm
from repro_torch.models import transformer as ttf
from repro_torch.models.common import layer_norm
from repro_torch.models.registry import build_model
from repro_torch.serve.decode import generate
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten

pytestmark = pytest.mark.tier1

LN_TOL_F32 = 1e-6
#: module outputs in f32: the f32 sums in another order
OUT_TOL_F32 = 1e-5
#: module outputs in bf16: two libraries' bf16 roundings
OUT_TOL_BF16 = 1e-2
MLP_DIFFER_FRAC = 1e-3
LM_F32_TOL = 1e-5
LOGIT_TOL = 1e-2
DECODE_TOL = 1e-3
SELF_DECODE_TOL = 3e-2
LOSS_RTOL = 4e-4
UPDATE_TOL = 5e-2
P, C, NEW = R.LM_PROMPT, R.LM_CACHE, R.LM_NEW
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
    return R.run("whisper_cases", str(tmp_path_factory.mktemp("ref") /
                                      "whisper.npz"))


@pytest.fixture(scope="module")
def base():
    return get_config(R.WHISPER_ARCH).reduced()


@pytest.fixture(scope="module")
def params(ref, base):
    return weights.lm_params_from_jax(ref["params"], base, "cpu")


@pytest.fixture(scope="module")
def tokens(base):
    return torch.from_numpy(R.lm_tokens(base))


@pytest.fixture(scope="module")
def frames(ref):
    return torch.from_numpy(ref["frames"])


def _t(x, dt):
    return torch.from_numpy(np.ascontiguousarray(x)).to(getattr(torch, dt))


def _rel(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    return float(np.abs(got - want).max() / np.abs(want).max())


def _jflat(tree):
    import jax
    is_pd = lambda x: hasattr(x, "init")
    leaves = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_pd)[0]
    return {"/".join(str(getattr(k, "key", k)) for k in path): pd
            for path, pd in leaves}


# ---------------------------------------------------------------------------
# the config and the descriptors


def test_config_and_param_count_equal_the_reference():
    """Field for field, full and reduced (the reduced encoder: 2 layers,
    16 frames, 4 heads, as the reference's ``reduced``)."""
    got, want = get_config(R.WHISPER_ARCH), jget_config(R.WHISPER_ARCH)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(got.reduced()) == \
        dataclasses.asdict(want.reduced())
    enc = got.reduced().encoder
    assert (enc.n_layers, enc.n_frames, enc.n_heads) == (2, 16, 4)
    assert param_count(got) == jparam_count(want)
    tree = sum(int(np.prod(pd.shape)) for pd in tree_leaves(ttf.lm_pd(got)))
    assert tree == sum(int(np.prod(pd.shape))
                       for pd in _jflat(jtf.lm_pd(want)).values())
    assert tree == 114_758_656


@pytest.mark.parametrize("which", ["lm_pd", "cache_pd"])
@pytest.mark.parametrize("reduced", [True, False])
def test_descriptors_equal_the_reference(which, reduced):
    """Paths, shapes, initializers, scales and dtypes: the encoder stack,
    its position table and norm, the decoder stack with its cross blocks,
    the 32,768-row position table, and the cache's ``self`` and ``cross``
    k and v."""
    cfg, jcfg = get_config(R.WHISPER_ARCH), jget_config(R.WHISPER_ARCH)
    if reduced:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    got, want = {
        "lm_pd": lambda: (ttf.lm_pd(cfg), jtf.lm_pd(jcfg)),
        "cache_pd": lambda: (ttf.cache_pd(cfg, 4, 200),
                             jtf.cache_pd(jcfg, 4, 200))}[which]()
    got, want = dict(tree_flatten(got)), _jflat(want)
    assert list(got) == sorted(want)
    for path, pd in got.items():
        w = want[path]
        assert (pd.shape, pd.init, pd.scale) == (w.shape, w.init,
                                                 w.scale), path
        assert str(pd.dtype).split(".")[-1] == str(np.dtype(w.dtype))


def test_stub_frames_are_per_step_and_in_the_batch(base):
    """``token_batch`` carries (B, n_frames, d) f32 frames, 0.02 · N(0, 1),
    the same for the same (seed, step) and new for another step."""
    b0 = token_batch(base, batch=2, seq=8, step=0, device="cpu")
    b1 = token_batch(base, batch=2, seq=8, step=1, device="cpu")
    f = b0["frames"]
    assert f.shape == (2, 16, 256) and f.dtype == torch.float32
    assert torch.equal(f, stub_frames(base, batch=2, step=0, device="cpu"))
    assert not torch.equal(f, b1["frames"])
    assert 0.01 < float(f.std()) < 0.03


# ---------------------------------------------------------------------------
# the pieces


@pytest.mark.parametrize("dt", DTYPES)
def test_layer_norm_matches_reference(ref, dt):
    x = _t(ref["inputs"]["x"], dt)
    p = ref["ln"]["params"]
    out = layer_norm(x, _t(p["scale"], dt), _t(p["bias"], dt))
    assert out.dtype == x.dtype
    want = ref["ln"][dt]
    if dt == "bfloat16":
        np.testing.assert_array_equal(out.float().numpy(), want)
    else:
        assert _rel(out, want) <= LN_TOL_F32


@pytest.mark.parametrize("dt", DTYPES)
def test_gelu_mlp_matches_reference(ref, dt):
    """``gelu(x W_in + b_in) W_out + b_out`` with the bf16 bias adds."""
    p = {n: _t(v, dt) for n, v in ref["mlp"]["params"].items()}
    out = mlpm.gelu_mlp_apply(p, _t(ref["inputs"]["x"], dt))
    want = ref["mlp"][dt]
    if dt == "bfloat16":
        assert (out.float().numpy() != want).mean() <= MLP_DIFFER_FRAC
        assert _rel(out, want) <= OUT_TOL_BF16
    else:
        assert _rel(out, want) <= OUT_TOL_F32


@pytest.mark.parametrize("flash", [0, 1])
@pytest.mark.parametrize("dt", DTYPES)
def test_cross_attention_matches_reference(ref, base, dt, flash):
    """``gqa_parallel(..., cross_x=enc, cache_len=16)``: 33 queries over
    16 encoder states, non-causal, no rope; the cache holds the encoder
    states' k and v."""
    cfg = dataclasses.replace(base, flash_attention=bool(flash))
    p = {n: _t(v, dt) for n, v in ref["cross"]["params"].items()}
    x, enc = _t(ref["inputs"]["x"], dt), _t(ref["inputs"]["enc"], dt)
    out, cache = attn.gqa_parallel(p, x, None, cfg, cross_x=enc,
                                   cache_len=base.encoder.n_frames)
    want = ref["cross"][dt][f"f{flash}"]
    tol = OUT_TOL_F32 if dt == "float32" else OUT_TOL_BF16
    assert out.shape == x.shape and out.dtype == x.dtype
    assert _rel(out, want["out"]) <= tol
    for name in ("k", "v"):
        assert cache[name].shape == want["cache"][name].shape
        assert _rel(cache[name], want["cache"][name]) <= tol


@pytest.mark.parametrize("dt", DTYPES)
def test_cross_attention_decode_matches_reference(ref, base, dt):
    """One token against the reference's cross cache, read only."""
    p = {n: _t(v, dt) for n, v in ref["cross"]["params"].items()}
    cache = {n: _t(v, dt) for n, v in ref["cross"][dt]["f0"]["cache"]
             .items()}
    before = {n: t.clone() for n, t in cache.items()}
    out, same = attn.gqa_decode(p, _t(ref["inputs"]["x_dec"], dt), 0, base,
                                cache, cross=True)
    assert same is cache
    for n, t in cache.items():
        assert torch.equal(t, before[n]), n
    want = ref["cross"][dt]["decode"]
    if dt == "bfloat16":
        np.testing.assert_array_equal(out.float().numpy(), want)
    else:
        assert _rel(out, want) <= OUT_TOL_F32


# ---------------------------------------------------------------------------
# the LM


def _model(base, flash):
    return build_model(dataclasses.replace(base, flash_attention=bool(flash)))


def test_f32_lm_and_gradients_match_reference(ref, base):
    """The whisper LM wholly in f32, encoder and decoder, forward and
    backward (``torch_reference.lm_f32_errors``), each leaf's gradient
    against its own largest."""
    d_logits, err, path, zero = R.lm_f32_errors(base, ref)
    assert d_logits <= LM_F32_TOL
    assert err <= LM_F32_TOL, (path, err)
    assert zero == []


@pytest.mark.parametrize("flash", [0, 1])
def test_forward_train_matches_reference(ref, base, params, tokens, frames,
                                         flash):
    (logits, aux), _ = _model(base, flash).forward_train(
        params, {"tokens": tokens, "frames": frames})
    assert logits.shape == (R.LM_BATCH, P + 1, base.vocab_size)
    assert logits.dtype == torch.float32 and float(aux) == 0.0
    assert _rel(logits, ref[f"f{flash}"]["train_logits"]) < LOGIT_TOL


@pytest.mark.parametrize("flash", [0, 1])
def test_prefill_and_decode_match_reference(ref, base, params, tokens,
                                            frames, flash):
    """The prefill's last logits and cache (``self``: the decoder's k, v
    (L, B, C, K, Dh); ``cross``: the encoder output's (L, B, 16, K, Dh);
    bf16), and one decode step from the reference's own cache, which
    writes its token's ``self`` rows in place and leaves ``cross``."""
    model = _model(base, flash)
    before = fa.flash_attention.launches
    last, cache = model.forward_prefill(
        params, {"tokens": tokens[:, :P], "frames": frames}, C)
    assert fa.flash_attention.launches == before    # CPU: no kernel
    r = ref[f"f{flash}"]
    assert _rel(last, r["prefill_logits"]) < LOGIT_TOL
    got, want = dict(tree_flatten(cache)), dict(tree_flatten(r["cache"]))
    assert sorted(got) == sorted(want) == ["cross/k", "cross/v", "self/k",
                                           "self/v"]
    for name, t in got.items():
        assert t.shape == want[name].shape and t.dtype == torch.bfloat16
        assert _rel(t, want[name]) < LOGIT_TOL, name
    cache = weights.cache_from_jax(r["cache"], model.cfg, R.LM_BATCH, C,
                                   "cpu")
    ptrs = [t.data_ptr() for t in tree_leaves(cache)]
    cross = {n: t.clone() for n, t in cache["cross"].items()}
    logits, new = model.forward_decode(params, cache, tokens[:, P:], P)
    assert new is cache and [t.data_ptr() for t in tree_leaves(cache)] \
        == ptrs
    for n, t in cache["cross"].items():
        assert torch.equal(t, cross[n]), n
    assert _rel(logits, r["decode_logits"]) < DECODE_TOL
    want = dict(tree_flatten(r["decode_cache"]))
    for name, t in tree_flatten(cache):
        assert _rel(t, want[name]) < DECODE_TOL, name


@pytest.mark.parametrize("flash", [0, 1])
def test_decode_matches_own_full_forward(base, params, tokens, frames,
                                         flash):
    """As ``tests/test_serve.py``: prefill + one decode step == the full
    forward's next position, within its 3e-2."""
    model = _model(base, flash)
    (full, _), _ = model.forward_train(params, {"tokens": tokens,
                                                "frames": frames})
    _, cache = model.forward_prefill(
        params, {"tokens": tokens[:, :P], "frames": frames}, C)
    dl, _ = model.forward_decode(params, cache, tokens[:, P:], P)
    assert _rel(dl[:, 0], full[:, -1].numpy()) < SELF_DECODE_TOL


@pytest.mark.parametrize("flash", [0, 1])
def test_generate_matches_reference_tokens(ref, base, params, tokens,
                                           frames, flash):
    """Greedy tokens equal the reference's up to a tie at bf16 resolution
    (``torch_reference.check_greedy_tokens``)."""
    model = _model(base, flash)
    out = generate(model, params, {"tokens": tokens[:, :P],
                                   "frames": frames}, max_new=NEW,
                   cache_len=C)
    assert out.dtype == torch.int32 and out.shape == (R.LM_BATCH, NEW)
    R.check_greedy_tokens(model, params, tokens[:, :P],
                          ref[f"f{flash}"]["generate"], out.numpy(), C,
                          frames=frames)


@pytest.mark.parametrize("k", range(R.LM_TRAIN_STEPS))
def test_train_step_matches_reference(ref, base, k):
    """``comm='xla'`` LARS steps from the reference's own states on its
    token batches (frames and all): the loss and each tensor's new params
    (``torch_reference.check_train_step``), and the momentum, each tensor
    within UPDATE_TOL of its largest element."""
    r = ref["train"][f"s{k}"]
    *_, state = R.check_train_step(r, base, loss_rtol=LOSS_RTOL,
                                   update_tol=UPDATE_TOL)
    want = dict(tree_flatten(r["out"]["mom"]))
    for path, m in tree_flatten(weights.to_numpy(state.mom)):
        assert np.isfinite(m).all(), path
        top = np.abs(want[path]).max()
        assert np.abs(m - want[path]).max() <= UPDATE_TOL * top, path


def test_remat_matches_no_remat(base, params, tokens, frames):
    """``cfg.remat`` recomputes each encoder and decoder layer in the
    backward: the same gradients bit for bit."""
    grads = []
    for remat in (False, True):
        model = build_model(dataclasses.replace(base, remat=remat))
        p = {n: t.clone().requires_grad_() for n, t in
             tree_flatten(params)}
        tree = tree_unflatten(list(p), list(p.values()))
        (logits, _), _ = model.forward_train(tree, {"tokens": tokens,
                                                    "frames": frames})
        logits.float().square().mean().backward()
        grads.append({n: t.grad for n, t in p.items()})
    for n in grads[0]:
        assert torch.equal(grads[0][n], grads[1][n]), n


# ---------------------------------------------------------------------------
# the entry points


def test_serve_and_train_clis_on_cpu(capsys):
    """``python -m repro_torch.serve.decode`` and ``python -m
    repro_torch.launch.train`` with ``--arch whisper-base --reduced
    --device cpu``, called in this process (an interpreter each would
    cost the suite more than the runs)."""
    from repro_torch.launch import train as launch
    from repro_torch.serve import decode
    decode.main(["--arch", R.WHISPER_ARCH, "--reduced", "--device", "cpu",
                 "--batch", "2", "--max-new", "4", "--flash-attention"])
    out = capsys.readouterr().out
    assert f"arch={R.WHISPER_ARCH} (reduced)" in out
    assert "generated (2, 4) tokens" in out
    history = launch.main(["--arch", R.WHISPER_ARCH, "--reduced", "--device",
                           "cpu", "--seq", "16", "--batch", "2", "--steps",
                           "2"])
    assert len(history) == 2 and all(np.isfinite(h["loss"])
                                     for h in history)
    assert "run_stop" in capsys.readouterr().out
