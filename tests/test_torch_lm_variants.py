"""The port's dense LM variants against the JAX package's, reduced (2
layers, d 256, 4 heads of 64, vocab 512): qwen3-14b (``qk_norm``, 4 query
heads on 1 kv head, θ 1e6), mistral-nemo-12b (sliding window, 32 when
reduced, with a 64-token prompt so the window bites in the prefill and the
decode) and qwen1.5-32b (QKV bias, MHA, an untied head; its ``fsdp`` only
sets the reference's partition specs). For each: the config field for
field, the descriptors, and forward, prefill, decode and greedy tokens
with the reference's params carried across (``tests/torch_reference.py
lm_variant_cases``: one subprocess, ``mesh=None``, XLA rounding at every
bf16 operation), at ``test_torch_lm.py``'s bounds; flash off, and on for
qwen3-14b and mistral-nemo-12b (the flash kernel's plain version here, the
Pallas kernel in interpret mode on the reference's side). Measured here:
logits within 1.1e-2 of their max, caches within 6.2e-3 with at most
1.4% of elements differing, decode from the reference's cache equal,
decode against the port's own full forward 1.1e-2; greedy tokens equal,
each case with one tie at bf16 resolution that both packages broke alike.

The window exposed fault 3.4 in the reference's chunked attention
(ROADMAP §3), which the port repairs; where it bites, the port is held
against the reference's flash path, which windows right."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch_reference as R

from repro.configs import get_config as jget_config
from repro.models import transformer as jtf
from repro_torch import weights
from repro_torch.configs import get_config
from repro_torch.models import transformer as ttf
from repro_torch.models.registry import build_model
from repro_torch.serve.decode import generate
from repro_torch.tree import tree_flatten

pytestmark = pytest.mark.tier1

#: test_torch_lm.py's bounds
LOGIT_TOL = 2e-2
CACHE_DIFFER_FRAC = 0.05
DECODE_TOL = 1e-3
SELF_DECODE_TOL = 3e-2
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = [(arch, flash) for arch, (_, flashes) in R.LM_VARIANTS.items()
         for flash in flashes]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return R.run("lm_variant_cases",
                 str(tmp_path_factory.mktemp("ref") / "variants.npz"))


def _setup(ref, arch, flash):
    """The reduced config (flash as asked), the model, the reference's
    params carried across, the tokens, the prompt length and the cache
    length."""
    prompt = R.LM_VARIANTS[arch][0]
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              flash_attention=bool(flash))
    params = weights.lm_params_from_jax(ref[arch]["params"], cfg, "cpu")
    toks = torch.from_numpy(R.lm_tokens(cfg, prompt=prompt))
    return cfg, build_model(cfg), params, toks, prompt, prompt + R.LM_NEW


def _rel(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("arch", list(R.LM_VARIANTS))
def test_config_and_descriptors_equal_reference(arch):
    """The config field for field (full and reduced); the params' and the
    cache's paths, shapes, initializers and scales."""
    import jax
    got, want = get_config(arch), jget_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    cfg, jcfg = got.reduced(), want.reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    is_pd = lambda x: hasattr(x, "init")
    for jt, tt in ((jtf.lm_pd(jcfg), ttf.lm_pd(cfg)),
                   (jtf.cache_pd(jcfg, 2, 40), ttf.cache_pd(cfg, 2, 40))):
        leaves = jax.tree_util.tree_flatten_with_path(jt, is_leaf=is_pd)[0]
        w = {"/".join(k.key for k in path): pd for path, pd in leaves}
        g = dict(tree_flatten(tt))
        assert list(g) == sorted(w)
        for path, pd in g.items():
            assert (pd.shape, pd.init, pd.scale) == (w[path].shape,
                                                     w[path].init,
                                                     w[path].scale), path
    layer = ttf.lm_pd(cfg)["layers"]["attn"]
    assert ("q_norm" in layer) == ("k_norm" in layer) == cfg.qk_norm


def _faulty_chunks(cfg, S) -> bool:
    """Fault 3.4 (ROADMAP §3): the reference's chunked attention attends
    past the window where the window is longer than the query chunk."""
    from repro_torch.models.attention import _fit
    return 0 < _fit(S, cfg.attn_chunk) < cfg.sliding_window


@pytest.mark.parametrize("arch,flash", CASES)
def test_forward_and_prefill_match_reference(ref, arch, flash):
    """The full forward over prompt + 1 tokens, and the prefill. Where the
    reference's chunked path has fault 3.4 (mistral-nemo-12b's 65 tokens
    make query chunks of 13 under a window of 32), the port's chunked
    forward is held against the reference's flash forward, which windows
    right."""
    cfg, model, params, toks, P, C = _setup(ref, arch, flash)
    r = ref[arch][f"f{flash}"]
    (logits, aux), _ = model.forward_train(params, {"tokens": toks})
    assert float(aux) == 0.0
    faulty = not flash and _faulty_chunks(cfg, P + 1)
    assert faulty == (arch == "mistral-nemo-12b" and not flash)
    want = ref[arch]["f1"]["train_logits"] if faulty else r["train_logits"]
    assert _rel(logits, want) < LOGIT_TOL
    last, cache = model.forward_prefill(params, {"tokens": toks[:, :P]}, C)
    assert _rel(last, r["prefill_logits"]) < LOGIT_TOL
    for name in ("k", "v"):
        got, want = cache[name], r["cache"][name]
        assert got.shape == want.shape and not got[:, :, P:].any()
        assert _rel(got, want) < LOGIT_TOL, name
        assert (got.float().numpy() != want).mean() < CACHE_DIFFER_FRAC


@pytest.mark.parametrize("arch,flash", CASES)
def test_decode_matches_reference_and_own_full_forward(ref, arch, flash):
    """One decode step from the reference's own cache; and prefill + one
    step against the port's own full forward (``test_serve.py``'s bound)."""
    cfg, model, params, toks, P, C = _setup(ref, arch, flash)
    r = ref[arch][f"f{flash}"]
    cache = weights.cache_from_jax(r["cache"], cfg, R.LM_BATCH, C, "cpu")
    logits, _ = model.forward_decode(params, cache, toks[:, P:], P)
    assert _rel(logits, r["decode_logits"]) < DECODE_TOL
    for name in ("k", "v"):
        assert _rel(cache[name][:, :, P], r["decode_cache"][name][:, :, P]) \
            < DECODE_TOL
    (full, _), _ = model.forward_train(params, {"tokens": toks})
    _, own = model.forward_prefill(params, {"tokens": toks[:, :P]}, C)
    dl, _ = model.forward_decode(params, own, toks[:, P:], P)
    assert _rel(dl[:, 0], full[:, -1].numpy()) < SELF_DECODE_TOL


@pytest.mark.parametrize("arch,flash", CASES)
def test_generate_matches_reference_tokens(ref, arch, flash):
    """Greedy tokens equal the reference's up to a tie at bf16 resolution
    (``torch_reference.check_greedy_tokens``)."""
    cfg, model, params, toks, P, C = _setup(ref, arch, flash)
    out = generate(model, params, {"tokens": toks[:, :P]}, max_new=R.LM_NEW,
                   cache_len=C)
    assert out.shape == (R.LM_BATCH, R.LM_NEW)
    R.check_greedy_tokens(model, params, toks[:, :P],
                          ref[arch][f"f{flash}"]["generate"], out.numpy(), C)


def test_the_window_bites(ref):
    """mistral-nemo-12b's reduced window (32) is shorter than its prompt:
    attending over every earlier token instead moves the logits well past
    the parity bound, so the tests above hold the window."""
    cfg, model, params, toks, P, C = _setup(ref, "mistral-nemo-12b", 0)
    assert 0 < cfg.sliding_window < P
    full = build_model(dataclasses.replace(cfg, sliding_window=0))
    a, _ = model.forward_prefill(params, {"tokens": toks[:, :P]}, C)
    b, _ = full.forward_prefill(params, {"tokens": toks[:, :P]}, C)
    assert _rel(b, a.numpy()) > 10 * LOGIT_TOL


def test_chunked_window_longer_than_the_chunk():
    """Fault 3.4 at the attention level: 65 positions in chunks of 13
    under a window of 32, against an exact masked softmax in f64. The
    port's chunked attention agrees; the reference's attends past the
    window for the later queries of a chunk."""
    import jax.numpy as jnp
    from repro.models.attention import chunked_attention as jchunked
    from repro_torch.models.attention import chunked_attention
    S, W, CH = 65, 32, 13
    q, k, v = R.attention_inputs((1, S, 2, 1, 16, 16), "float32", 7)
    i = np.arange(S)
    mask = (i[None] <= i[:, None]) & (i[None] > i[:, None] - W)
    s = np.einsum("bqhd,bkd->bhqk", q.astype(np.float64),
                  k[:, :, 0].astype(np.float64)) * 16 ** -0.5
    s = np.where(mask, s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    exact = np.einsum("bhqk,bkd->bqhd", p / p.sum(-1, keepdims=True),
                      v[:, :, 0].astype(np.float64))
    got = chunked_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                            q_offset=0, causal=True, window=W, chunk=CH)
    theirs = np.asarray(jchunked(*(jnp.asarray(x) for x in (q, k, v)),
                                 q_offset=0, causal=True, window=W,
                                 chunk=CH))
    assert np.abs(got.numpy() - exact).max() < 1e-5
    assert np.abs(theirs - exact).max() > 1e-2


def test_qk_norm_is_applied(ref):
    """qwen3-14b's q_norm and k_norm scales reach the logits: scaling them
    changes the prefill's, and the reference's params put them off 1."""
    cfg, model, params, toks, P, C = _setup(ref, "qwen3-14b", 0)
    a, _ = model.forward_prefill(params, {"tokens": toks[:, :P]}, C)
    attn = dict(params["layers"]["attn"], q_norm=3 * params["layers"][
        "attn"]["q_norm"])
    b, _ = model.forward_prefill(dict(params, layers=dict(
        params["layers"], attn=attn)), {"tokens": toks[:, :P]}, C)
    assert _rel(b, a.numpy()) > 10 * LOGIT_TOL


def test_serving_twin_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.serve_decode",
         "--arch", "qwen3-14b", "--device", "cpu", "--batch", "2",
         "--max-new", "4"], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, PYTHONPATH=os.path.join(ROOT,
                                                                  "src")))
    assert out.returncode == 0, out.stderr
    assert "arch=qwen3-14b generated (2, 4) tokens" in out.stdout
