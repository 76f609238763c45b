"""The port's prefix VLM (the reduced internvl2-2b: d 256, 4 query heads on
2 kv heads of 64, 2 layers, d_ff 512, vocab 512; 16 stub patch embeddings
through the stub projector ``proj`` ahead of the tokens) against the JAX
package's, on the reference's own numpy inputs (``tests/torch_reference.py
vlm_cases``: one subprocess, ``mesh=None``, XLA rounding at every bf16
operation).

Wholly in f32 (``precision.f32_compute``; the reference's bf16 cast of the
projected prefix reads as f32 there): logits over the prefix and the
tokens within 1e-5 of their max and each leaf's gradient within 1e-5 of
its own largest (measured 1.5e-6 and 1.9e-6). In bf16, flash off and on:
logits and the prefill's last logits within 1e-2 (measured 5.8e-3 and
7.8e-3), the cache (its first 16 rows the prefix's) within 1e-2 of its max
and at most 5% of its elements apart (measured 0.8% and 3.0%); one decode
step from the reference's cache, at position 16 + 32, within 2e-2
(``test_torch_lm.py``'s logit bound; measured 6.9e-3 and 9.3e-3: the
step's bf16 matmuls round apart over 2 layers); decode against the port's
own full forward within 3e-2 (``tests/test_serve.py``; measured 8.2e-3 and
9.3e-3); greedy tokens equal up to a bf16 tie; two ``comm='xla'`` training
steps from the reference's states, loss within 4e-4 relative (measured
1.2e-4 and 1.4e-4), each tensor's params and momentum within 5e-2 of its
largest (measured 1.3e-2 and 1.1e-2). The loss left-pads the labels with
IGNORE over the prefix; the step's accuracy reads 0, as the reference's
does (it counts no label when the labels are narrower than the logits:
ROADMAP §3, "Not faults")."""
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
from repro_torch.core.label_smoothing import IGNORE
from repro_torch.models import transformer as ttf
from repro_torch.models.registry import build_model
from repro_torch.serve.decode import generate, prefix_len
from repro_torch.train.step import _lm_loss, make_loss_fn
from repro_torch.tree import tree_flatten, tree_leaves

pytestmark = pytest.mark.tier1

LM_F32_TOL = 1e-5
LOGIT_TOL = 1e-2
CACHE_DIFFER_FRAC = 0.05
DECODE_TOL = 2e-2
SELF_DECODE_TOL = 3e-2
LOSS_RTOL = 4e-4
UPDATE_TOL = 5e-2
P, NEW = R.LM_PROMPT, R.LM_NEW


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: the suite runs six workers on the CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(2, before))
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return R.run("vlm_cases", str(tmp_path_factory.mktemp("ref") /
                                  "vlm.npz"))


@pytest.fixture(scope="module")
def base():
    return get_config(R.VLM_ARCH).reduced()


@pytest.fixture(scope="module")
def C(base):
    """The cache: the prefix, the prompt and the new tokens."""
    return base.encoder.n_frames + R.LM_CACHE


@pytest.fixture(scope="module")
def params(ref, base):
    return weights.lm_params_from_jax(ref["params"], base, "cpu")


@pytest.fixture(scope="module")
def tokens(base):
    return torch.from_numpy(R.lm_tokens(base))


@pytest.fixture(scope="module")
def frames(ref):
    return torch.from_numpy(ref["frames"])


def _rel(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    return float(np.abs(got - want).max() / np.abs(want).max())


def _jflat(tree):
    import jax
    is_pd = lambda x: hasattr(x, "init")
    leaves = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_pd)[0]
    return {"/".join(str(getattr(k, "key", k)) for k in path): pd
            for path, pd in leaves}


def _model(base, flash):
    return build_model(dataclasses.replace(base, flash_attention=bool(flash)))


@pytest.mark.parametrize("reduced", [True, False])
def test_config_and_descriptors_equal_the_reference(reduced):
    """Field for field, and the LM's and the cache's descriptors: the
    dense stack and the stub projector ``proj`` (d, d)."""
    cfg, jcfg = get_config(R.VLM_ARCH), jget_config(R.VLM_ARCH)
    if reduced:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert param_count(cfg) == jparam_count(jcfg)
    for got, want in ((ttf.lm_pd(cfg), jtf.lm_pd(jcfg)),
                      (ttf.cache_pd(cfg, 2, 300), jtf.cache_pd(jcfg, 2,
                                                               300))):
        got, want = dict(tree_flatten(got)), _jflat(want)
        assert list(got) == sorted(want)
        for path, pd in got.items():
            w = want[path]
            assert (pd.shape, pd.init, pd.scale) == (w.shape, w.init,
                                                     w.scale), path
            assert str(pd.dtype).split(".")[-1] == str(np.dtype(w.dtype))
    if not reduced:
        tree = sum(int(np.prod(pd.shape))
                   for pd in tree_leaves(ttf.lm_pd(cfg)))
        assert tree == 1_893_341_184
        assert prefix_len(cfg) == 256


def test_f32_lm_and_gradients_match_reference(ref, base):
    """The VLM wholly in f32, forward over prefix and tokens and backward
    (``torch_reference.lm_f32_errors``), each leaf's gradient (the
    projector's among them) against its own largest."""
    d_logits, err, path, zero = R.lm_f32_errors(base, ref)
    assert d_logits <= LM_F32_TOL
    assert err <= LM_F32_TOL, (path, err)
    assert zero == []


@pytest.mark.parametrize("flash", [0, 1])
def test_forward_train_matches_reference(ref, base, params, tokens, frames,
                                         flash):
    """The logits cover the 16 prefix positions and the 33 tokens'."""
    (logits, aux), _ = _model(base, flash).forward_train(
        params, {"tokens": tokens, "frames": frames})
    assert logits.shape == (R.LM_BATCH, 16 + P + 1, base.vocab_size)
    assert float(aux) == 0.0
    assert _rel(logits, ref[f"f{flash}"]["train_logits"]) < LOGIT_TOL


@pytest.mark.parametrize("flash", [0, 1])
def test_prefill_and_decode_match_reference(ref, base, params, tokens,
                                            frames, C, flash):
    """The prefill's last logits and cache (rows 0-15 the prefix's, 16-47
    the prompt's), and one decode step at position 48 from the reference's
    own cache, written in place."""
    model = _model(base, flash)
    last, cache = model.forward_prefill(
        params, {"tokens": tokens[:, :P], "frames": frames}, C)
    r = ref[f"f{flash}"]
    assert _rel(last, r["prefill_logits"]) < LOGIT_TOL
    want = dict(tree_flatten(r["cache"]))
    for name, t in tree_flatten(cache):
        assert t.shape == want[name].shape == (base.n_layers, R.LM_BATCH,
                                               C, 2, 64)
        assert _rel(t, want[name]) < LOGIT_TOL, name
        assert (t.float().numpy() != want[name]).mean() \
            < CACHE_DIFFER_FRAC, name
        assert float(t[:, :, 16 + P:].abs().max()) == 0.0, name
    cache = weights.cache_from_jax(r["cache"], model.cfg, R.LM_BATCH, C,
                                   "cpu")
    ptrs = [t.data_ptr() for t in tree_leaves(cache)]
    start = prefix_len(base) + P
    logits, new = model.forward_decode(params, cache, tokens[:, P:], start)
    assert new is cache and [t.data_ptr() for t in tree_leaves(cache)] \
        == ptrs
    assert _rel(logits, r["decode_logits"]) < DECODE_TOL
    assert float(cache["k"][:, :, start].abs().max()) > 0


@pytest.mark.parametrize("flash", [0, 1])
def test_decode_matches_own_full_forward(base, params, tokens, frames, C,
                                         flash):
    model = _model(base, flash)
    (full, _), _ = model.forward_train(params, {"tokens": tokens,
                                                "frames": frames})
    _, cache = model.forward_prefill(
        params, {"tokens": tokens[:, :P], "frames": frames}, C)
    dl, _ = model.forward_decode(params, cache, tokens[:, P:],
                                 prefix_len(base) + P)
    assert _rel(dl[:, 0], full[:, -1].numpy()) < SELF_DECODE_TOL


@pytest.mark.parametrize("flash", [0, 1])
def test_generate_matches_reference_tokens(ref, base, params, tokens,
                                           frames, C, flash):
    """``generate`` counts the prefix in the positions; greedy tokens equal
    the reference's up to a bf16 tie; a cache without room for the prefix
    is refused."""
    model = _model(base, flash)
    batch = {"tokens": tokens[:, :P], "frames": frames}
    out = generate(model, params, batch, max_new=NEW, cache_len=C)
    assert out.shape == (R.LM_BATCH, NEW)
    R.check_greedy_tokens(model, params, tokens[:, :P],
                          ref[f"f{flash}"]["generate"], out.numpy(), C,
                          frames=frames)
    with pytest.raises(ValueError, match="cache_len"):
        generate(model, params, batch, max_new=NEW, cache_len=P + NEW)


@pytest.mark.parametrize("k", range(R.LM_TRAIN_STEPS))
def test_train_step_matches_reference(ref, base, k):
    """``comm='xla'`` LARS steps from the reference's own states on its
    token batches (frames and all): the loss, each tensor's new params and
    momentum; the accuracy reads 0 on both sides."""
    r = ref["train"][f"s{k}"]
    *_, state = R.check_train_step(r, base, loss_rtol=LOSS_RTOL,
                                   update_tol=UPDATE_TOL)
    assert float(r["metrics"]["acc"]) == 0.0
    want = dict(tree_flatten(r["out"]["mom"]))
    for path, m in tree_flatten(weights.to_numpy(state.mom)):
        top = np.abs(want[path]).max()
        assert np.abs(m - want[path]).max() <= UPDATE_TOL * top, path


def test_loss_pads_the_prefix_labels_and_accuracy_reads_zero(ref, base,
                                                             params, tokens,
                                                             frames):
    """``_lm_loss`` left-pads the 32 labels with IGNORE over the 16 prefix
    positions: loss and count equal the reference's (K4's plain version
    here); the same loss as with the labels padded by hand; and the loss
    function's accuracy is 0, as the reference's."""
    r = ref["loss"]
    logits = torch.from_numpy(r["logits"])
    labels = torch.from_numpy(r["labels"])
    loss, n = _lm_loss(logits, labels, smoothing=0.1)
    assert int(n) == int(r["n"]) == R.LM_BATCH * (P - 1)
    assert abs(float(loss) - float(r["loss"])) <= 1e-6 * abs(float(r["loss"]))
    padded = torch.cat([torch.full((R.LM_BATCH, 16), IGNORE,
                                   dtype=labels.dtype), labels], dim=1)
    assert float(_lm_loss(logits, padded, smoothing=0.1)[0]) == float(loss)
    assert float(r["acc"]) == 0.0
    loss_fn = make_loss_fn(build_model(base))
    _, (metrics, _) = loss_fn(params, {"tokens": tokens[:, :P],
                                       "frames": frames,
                                       "labels": tokens[:, 1:]})
    assert float(metrics["acc"]) == 0.0 and float(metrics["loss"]) > 0


def test_serve_cli_on_cpu(capsys):
    """``python -m repro_torch.serve.decode --arch internvl2-2b --reduced
    --device cpu``, called in this process: the cache gets room for the
    prefix."""
    from repro_torch.serve import decode
    decode.main(["--arch", R.VLM_ARCH, "--reduced", "--device", "cpu",
                 "--batch", "2", "--max-new", "4", "--flash-attention"])
    out = capsys.readouterr().out
    assert f"arch={R.VLM_ARCH} (reduced)" in out
    assert "generated (2, 4) tokens" in out
