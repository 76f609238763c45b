"""The port's dense LM (qwen1.5-0.5b, reduced: 2 layers, d 256, 4 heads of
64, vocab 512) against the JAX package's, with the reference's params
carried across by ``weights.lm_params_from_jax``, for ``flash_attention``
False (the chunked path) and True (the flash kernel's plain version here;
the Pallas kernel in interpret mode on the reference's side).

The reference runs in a subprocess with XLA rounding at every bf16
operation (``tests/torch_reference.py lm_cases``), with ``mesh=None``.
Both packages compute in bf16 with f32 softmax and norms, and agree op for
op (XLA's bf16 sigmoid is matched, ROADMAP §3); what remains is the order
of the f32 sums inside the bf16 matmuls, which flips the rounding of one
element in 10^4 in the first layer and compounds to one in 100 in the
second. Measured here: logits within 5.3e-3 of the logit max, cache leaves
within 3.9e-3 of their max with at most 1.3% of elements differing, decode
logits from the reference's own cache within 1.3e-5. The bounds are 2e-2
(logits and caches, about 4x the measured), 5% of elements, and 1e-3
(decode); decode against the port's own full forward is held to the
reference's own bound, 3e-2 of the logit max (``test_serve.py``)."""
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
from repro_torch.core import lars, pinit
from repro_torch.core.schedule import ScheduleConfig, make_schedule
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import transformer as ttf
from repro_torch.models.registry import build_model
from repro_torch.serve.decode import generate
from repro_torch.train.step import make_train_step
from repro_torch.tree import tree_flatten

pytestmark = pytest.mark.tier1

LOGIT_TOL = 2e-2
CACHE_DIFFER_FRAC = 0.05
DECODE_TOL = 1e-3
SELF_DECODE_TOL = 3e-2
P, C, NEW = R.LM_PROMPT, R.LM_CACHE, R.LM_NEW


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return R.run("lm_cases", str(tmp_path_factory.mktemp("ref") / "lm.npz"))


@pytest.fixture(scope="module")
def base():
    return get_config(R.LM_ARCH).reduced()


@pytest.fixture(scope="module")
def params(ref, base):
    return weights.lm_params_from_jax(ref["params"], base, "cpu")


@pytest.fixture(scope="module")
def tokens(base):
    return torch.from_numpy(R.lm_tokens(base))


def _model(base, flash):
    return build_model(dataclasses.replace(base, flash_attention=bool(flash)))


def _rel(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_lm_descriptors_match_reference(base):
    """Paths, shapes, initializers and scales of the params and the cache
    equal the reference's descriptor trees."""
    import jax
    jcfg = jget_config(R.LM_ARCH).reduced()
    is_pd = lambda x: hasattr(x, "init")

    def jflat(tree):
        leaves = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_pd)[0]
        return {"/".join(k.key for k in path): pd for path, pd in leaves}

    for jt, tt in ((jtf.lm_pd(jcfg), ttf.lm_pd(base)),
                   (jtf.cache_pd(jcfg, 2, 40), ttf.cache_pd(base, 2, 40))):
        want, got = jflat(jt), dict(tree_flatten(tt))
        assert list(got) == sorted(want)
        for path, pd in got.items():
            w = want[path]
            assert (pd.shape, pd.init, pd.scale) == (w.shape, w.init,
                                                     w.scale), path
            assert str(pd.dtype).split(".")[-1] == str(np.dtype(w.dtype))


def test_pinit_materializes_stacked_and_bf16_leaves(base):
    """A stacked (L, ...) leaf is one draw from its path's seed, so its
    layers differ; the cache's bf16 zero descriptors come out bf16."""
    model = build_model(base)
    params = pinit.materialize(model.param_pd, 3, "cpu")
    for path, pd in tree_flatten(model.param_pd):
        x = dict(tree_flatten(params))[path]
        assert tuple(x.shape) == pd.shape and x.dtype == pd.dtype, path
    wq = params["layers"]["attn"]["wq"]
    assert wq.shape[0] == base.n_layers and not torch.equal(wq[0], wq[1])
    again = pinit.materialize(model.param_pd, 3, "cpu")
    assert torch.equal(again["layers"]["attn"]["wq"], wq)
    cache = pinit.materialize(model.cache_pd(2, 16), 0, "cpu")
    for _, x in tree_flatten(cache):
        assert x.dtype == torch.bfloat16 and not x.any()
        assert tuple(x.shape) == (base.n_layers, 2, 16, base.n_kv_heads,
                                  base.resolved_head_dim)


@pytest.mark.parametrize("flash", [0, 1])
def test_forward_train_matches_reference(ref, base, params, tokens, flash):
    (logits, aux), _ = _model(base, flash).forward_train(
        params, {"tokens": tokens})
    want = ref[f"f{flash}"]["train_logits"]
    assert logits.dtype == torch.float32 and logits.shape == want.shape
    assert float(aux) == 0.0
    assert _rel(logits, want) < LOGIT_TOL


@pytest.mark.parametrize("flash", [0, 1])
def test_prefill_matches_reference(ref, base, params, tokens, flash):
    before = fa.flash_attention.launches
    last, cache = _model(base, flash).forward_prefill(
        params, {"tokens": tokens[:, :P]}, C)
    assert fa.flash_attention.launches == before    # CPU: no kernel
    r = ref[f"f{flash}"]
    assert _rel(last, r["prefill_logits"]) < LOGIT_TOL
    for name in ("k", "v"):
        got, want = cache[name], r["cache"][name]
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        assert not got[:, :, P:].any()             # rows past the prompt
        assert _rel(got, want) < LOGIT_TOL, name
        differ = (got.float().numpy() != want).mean()
        assert differ < CACHE_DIFFER_FRAC, (name, differ)


@pytest.mark.parametrize("flash", [0, 1])
def test_decode_matches_reference(ref, base, params, tokens, flash):
    """One decode step from the reference's own cache: the new row is
    written in place, the rest of the cache is untouched."""
    r = ref[f"f{flash}"]
    model = _model(base, flash)
    cache = weights.cache_from_jax(r["cache"], model.cfg, R.LM_BATCH, C,
                                   "cpu")
    before = {n: t.clone() for n, t in cache.items()}
    logits, out = model.forward_decode(params, cache, tokens[:, P:], P)
    assert out is cache
    assert _rel(logits, r["decode_logits"]) < DECODE_TOL
    for name in ("k", "v"):
        rows = [i for i in range(C) if i != P]
        assert torch.equal(cache[name][:, :, rows], before[name][:, :, rows])
        assert _rel(cache[name][:, :, P], r["decode_cache"][name][:, :, P]) \
            < DECODE_TOL


@pytest.mark.parametrize("flash", [0, 1])
def test_decode_matches_own_full_forward(base, params, tokens, flash):
    """As ``test_serve.py::test_decode_matches_full_forward``: prefill of
    the prompt + one decode step == the full forward's next position."""
    model = _model(base, flash)
    (full, _), _ = model.forward_train(params, {"tokens": tokens})
    _, cache = model.forward_prefill(params, {"tokens": tokens[:, :P]}, C)
    dl, _ = model.forward_decode(params, cache, tokens[:, P:], P)
    assert _rel(dl[:, 0], full[:, -1].numpy()) < SELF_DECODE_TOL


@pytest.mark.parametrize("flash", [0, 1])
def test_generate_matches_reference_tokens(ref, base, params, tokens, flash):
    """Greedy tokens equal the reference's. Measured here: equal for both
    paths, no bf16 tie at any step. Should a change flip a near-tie, the
    logits tests above bound the difference; this test then fails and the
    margin at the first differing step has to be checked."""
    timings = {}
    out = generate(_model(base, flash), params, {"tokens": tokens[:, :P]},
                   max_new=NEW, cache_len=C, timings=timings)
    assert out.dtype == torch.int32 and out.shape == (R.LM_BATCH, NEW)
    np.testing.assert_array_equal(out.numpy(), ref[f"f{flash}"]["generate"])
    assert len(timings["decode_ms"]) == NEW - 1


def test_generate_refuses_a_short_cache(base, params, tokens):
    with pytest.raises(ValueError, match="cache_len"):
        generate(build_model(base), params, {"tokens": tokens[:, :P]},
                 max_new=NEW, cache_len=P + NEW - 1)


def test_serve_cli_on_cpu():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.serve.decode", "--reduced",
         "--device", "cpu", "--batch", "2", "--max-new", "4"],
        cwd=root, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=os.path.join(root, "src")))
    assert out.returncode == 0, out.stderr
    assert "generated (2, 4) tokens" in out.stdout
    assert "first request's tokens: [" in out.stdout


def test_serve_entry_points_raise_without_card(monkeypatch):
    """No silent CPU fallback: without a card and without --device cpu."""
    from repro_torch.launch import profile_serve
    from repro_torch.serve import decode
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (decode.main, profile_serve.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--reduced"])


def test_unported_lm_parts_name_roadmap(base, monkeypatch):
    """Item 10.6 is ported: whisper's and the VLM's configs resolve and
    their families build (``test_torch_whisper.py``, ``test_torch_vlm.py``
    hold them against the reference); an unknown arch names the known
    ones; the CLI has every flag of the reference's, ``--model-parallel``
    since item 6.2 (the dense decoder, ``test_torch_tp.py``; the hybrid
    and the xLSTM since item 6.2b, ``test_torch_tp_recurrent.py``;
    whisper and the VLM since item 6.2c, ``test_torch_tp_frames.py``):
    whisper at ``--model-parallel 2`` under a two-rank launch reaches the
    run, and so do the MoE decoder since item 6.3's first part
    (``test_torch_tp_moe.py``) and MLA since its MLA part
    (``test_torch_tp_mla.py``); what the model axis does not split yet
    names its item (the published deepseek-v2-236b's ``fsdp`` over two
    data ranks: 6.3)."""
    from repro_torch.configs import _REGISTRY
    from repro_torch.launch import train as cli
    for arch, fam in (("whisper-base", "audio"), ("internvl2-2b", "vlm")):
        cfg = get_config(arch)
        assert cfg.family == fam and arch in _REGISTRY
        model = build_model(cfg.reduced())
        assert "enc_layers" in model.param_pd if fam == "audio" \
            else "proj" in model.param_pd
    # the explicit-DP LM step is ported: like the conv family's, it needs
    # a mesh (test_torch_lm_dp.py trains it)
    with pytest.raises(ValueError, match="needs a mesh"):
        make_train_step(build_model(base), lars.OptConfig(),
                        make_schedule(ScheduleConfig(base_lr=0.1,
                                                     total_steps=2)),
                        comm="psum")
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("whisper-large")
    monkeypatch.setenv("WORLD_SIZE", "2")
    ran = []
    monkeypatch.setattr(cli, "_run", ran.append)
    for arch in ("whisper-base", "qwen2-moe-a2.7b", "deepseek-v2-236b"):
        cli.main(["--arch", arch, "--model-parallel", "2", "--device",
                  "cpu"])
        assert len(ran) == 1 and ran.pop().model_parallel == 2
    from repro_torch.launch.mesh import Axis, Mesh
    two = Mesh((Axis("data", 2, 0, (0, 2), None),
                Axis("model", 2, 0, (0, 1), None)), torch.device("cpu"))
    with pytest.raises(NotImplementedError, match=r"ROADMAP §1 item 6\.3\)"):
        ttf.tp_axis(get_config("deepseek-v2-236b"), two)
