"""The port's Mamba2 block (``models/mamba.py``) and the hybrid LM (the
reduced zamba2-7b: 4 Mamba layers in 2 groups of 2, d 256, 16 SSM heads
of 32, state 16, chunk 16; a shared attention block of 4 heads of 64
applied before each group; vocab 512) against the JAX package's, on the
reference's own numpy inputs (``tests/torch_reference.py mamba_cases``: one
subprocess, ``mesh=None``, XLA rounding at every bf16 operation).

The module: ``mamba_parallel`` with and without a cache at 32 and 33
tokens in f32 (33 takes the largest divisor chunk, 11, with a cache and
zero padding without) and at 32 in bf16, and ``mamba_decode`` from the
reference's cache, in f32 within 1e-5 of each output's max (measured
1.0e-6) and in bf16 within 2e-2 (measured 2.7e-3; the reference's own
cross-form bound is 5e-2); the f32 gradients at 32 tokens leaf by leaf,
each within 1e-5 of its own largest (measured 4.0e-6, A_log;
``torch_reference.leaf_grad_errors``).

The LM. Wholly in f32 (``torch_reference._lm_f32_case``, 33 tokens, so
the zero-padded chunks too; ``precision.f32_compute``), logits within
2e-5 of their max and each leaf's gradient within 2e-5 of its own
largest (measured 2.5e-6 and 4.9e-6, A_log); no leaf's gradient
vanishes. In bf16, flash off and on, each block rounds apart from the
reference's where a bf16 matmul's summation order flips a rounding, and
attention and the SSD spread such a flip along the sequence; through six
blocks the logits part by 1.6e-2 and 1.7e-2 of their max, so the logits,
the prefill's last logits and its caches are held to 2e-2
(``test_torch_lm.py``'s bound), not to 1e-2
(``tools/hybrid_depth_rounding.py`` shows such differences growing with
depth, and not in f32); the first application's k and v to a 5% share of
elements apart (measured 0.02%); one decode step from the reference's
cache to 1e-2 (measured 0 and 5.1e-3); greedy tokens (equal up to a bf16
tie); the decode against the port's own full forward to 3e-2
(``tests/test_serve.py``'s bound; measured 1.6e-2 and 2.0e-2); two
``comm='xla'`` training steps from the reference's states: the loss
within 4e-4 relative (``test_torch_moe.py``'s bound; measured 1.3e-4 and
1.3e-5), each tensor's new params within 5e-2 of its largest update and
its momentum of its largest (measured 3.6e-2 and 2.3e-2, both)."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch_reference as R

from repro.configs import get_config as jget_config
from repro.configs import param_count as jparam_count
from repro.models import mamba as jmb
from repro.models import transformer as jtf
from repro_torch import weights
from repro_torch.configs import get_config, param_count
from repro_torch.core import pinit
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import mamba as mb
from repro_torch.models import transformer as ttf
from repro_torch.models.registry import build_model
from repro_torch.serve.decode import generate
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten

pytestmark = pytest.mark.tier1

#: module outputs and states in f32: the f32 sums in another order
OUT_TOL_F32 = 1e-5
#: module outputs in bf16: two libraries' bf16 roundings
OUT_TOL_BF16 = 2e-2
#: the f32 module gradients, each leaf of its own largest
GRAD_TOL = 1e-5
#: the f32 LM's logits, and each leaf's gradient (the module docstring)
LM_F32_TOL = 2e-5
#: the bf16 LM's logits, prefill and caches against the reference's
#: (flash off and on): test_torch_lm.py's bound
LOGIT_TOL = 2e-2
CACHE_DIFFER_FRAC = 0.05
DECODE_TOL = 1e-2
#: decode against the port's own full forward (tests/test_serve.py)
SELF_DECODE_TOL = 3e-2
LOSS_RTOL = 4e-4
#: chip_smoke.py's LM_UPDATE_TOL
UPDATE_TOL = 5e-2
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
    return R.run("mamba_cases", str(tmp_path_factory.mktemp("ref") /
                                    "mamba.npz"))


@pytest.fixture(scope="module")
def base():
    return get_config(R.HYBRID_ARCH).reduced()


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


def _jflat(tree):
    import jax
    is_pd = lambda x: hasattr(x, "init")
    leaves = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_pd)[0]
    return {"/".join(str(getattr(k, "key", k)) for k in path): pd
            for path, pd in leaves}


# ---------------------------------------------------------------------------
# the config and the descriptors


def test_config_and_param_count_equal_the_reference():
    """Field for field, full and reduced. ``param_count`` is the
    reference's accounting, 10.84 B: it counts B and C once a head; the
    tree holds 6.75 B (PERF.md records the gap)."""
    got, want = get_config(R.HYBRID_ARCH), jget_config(R.HYBRID_ARCH)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(got.reduced()) == \
        dataclasses.asdict(want.reduced())
    assert param_count(got) == jparam_count(want) == 10_839_392_256
    tree = sum(int(np.prod(pd.shape))
               for pd in tree_leaves(ttf.lm_pd(got)))
    assert tree == 6_750_539_856
    assert [len(ttf._hybrid_groups(c)) for c in (got, got.reduced())] \
        == [14, 2]


@pytest.mark.parametrize("which", ["mamba_pd", "lm_pd", "cache_pd"])
@pytest.mark.parametrize("reduced", [True, False])
def test_descriptors_equal_the_reference(which, reduced):
    """Paths, shapes, initializers, scales and dtypes: the Mamba block's,
    the hybrid LM's (stacked layers and the shared block) and its cache
    (the shared block's k, v stacked over its applications, the Mamba
    windows and states over the layers)."""
    cfg, jcfg = get_config(R.HYBRID_ARCH), jget_config(R.HYBRID_ARCH)
    if reduced:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    got, want = {
        "mamba_pd": lambda: (mb.mamba_pd(cfg), jmb.mamba_pd(jcfg)),
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


# ---------------------------------------------------------------------------
# the module


def _module(ref, dt):
    return {n: _t(v, dt) for n, v in ref["mamba"]["params"].items()}


def _assert_close(got, want, dt, what):
    tol = OUT_TOL_F32 if dt == "float32" else OUT_TOL_BF16
    assert got.shape == want.shape, what
    assert _rel(got, want) <= tol, (what, _rel(got, want))


@pytest.mark.parametrize("dt,S", [("float32", S) for S in R.SSM_LENGTHS]
                         + [("bfloat16", R.SSM_LENGTHS[0])])
def test_mamba_parallel_matches_reference(ref, base, dt, S):
    """With a cache (the last three raw conv inputs and the f32 state)
    and without; at 33 tokens the two take different chunks (11, and 16
    over a zero-padded end)."""
    p, x = _module(ref, dt), _t(ref["mamba"][f"x{S}"], dt)
    want = ref["mamba"][dt][f"s{S}"]
    out, cache = mb.mamba_parallel(p, x, base, return_cache=True)
    out_nc, none = mb.mamba_parallel(p, x, base)
    assert none is None and out.dtype == x.dtype
    _assert_close(out, want["out"], dt, "out")
    _assert_close(out_nc, want["out_nc"], dt, "out without cache")
    assert sorted(cache) == sorted(want["cache"])
    assert cache["state"].dtype == torch.float32
    for name, t in cache.items():
        assert t.is_contiguous()
        _assert_close(t, want["cache"][name], dt, name)


@pytest.mark.parametrize("S", R.SSM_LENGTHS[:1])
def test_mamba_f32_gradients_match_reference(ref, base, S):
    """The f32 gradients of ``mamba_parallel`` (no cache) with respect to
    every param and the input, leaf by leaf
    (``torch_reference.module_grads_error``); the 33-token path's are the
    LM's (``test_f32_lm_and_gradients_match_reference``)."""
    err, path, zero = R.module_grads_error(mb.mamba_parallel, ref, "mamba",
                                           S, base)
    assert err <= GRAD_TOL, (path, err)
    assert zero == []


@pytest.mark.parametrize("dt", DTYPES)
def test_mamba_decode_matches_reference_in_place(ref, base, dt):
    """One step from the reference's 32-token cache: the output and the
    new windows and state, written into the given cache's storage."""
    p, x = _module(ref, dt), _t(ref["mamba"]["x_dec"], dt)
    r = ref["mamba"][dt]
    cache = {n: _t(v, dt if n != "state" else "float32")
             for n, v in r["s32"]["cache"].items()}
    ptrs = {n: t.data_ptr() for n, t in cache.items()}
    out, new = mb.mamba_decode(p, x, base, cache)
    assert new is cache
    assert {n: t.data_ptr() for n, t in cache.items()} == ptrs
    _assert_close(out, r["decode"]["out"], dt, "out")
    for name, t in cache.items():
        _assert_close(t, r["decode"]["cache"][name], dt, name)


# ---------------------------------------------------------------------------
# the hybrid LM


def _model(base, flash):
    return build_model(dataclasses.replace(base, flash_attention=bool(flash)))


def test_f32_lm_and_gradients_match_reference(ref, base):
    """The hybrid LM wholly in f32, forward and backward
    (``torch_reference.lm_f32_errors``), each leaf's gradient against its
    own largest."""
    d_logits, err, path, zero = R.lm_f32_errors(base, ref)
    assert d_logits <= LM_F32_TOL
    assert err <= LM_F32_TOL, (path, err)
    assert zero == []


@pytest.mark.parametrize("flash", [0, 1])
def test_forward_train_matches_reference(ref, base, params, tokens, flash):
    (logits, aux), _ = _model(base, flash).forward_train(
        params, {"tokens": tokens})
    assert logits.dtype == torch.float32 and float(aux) == 0.0
    assert _rel(logits, ref[f"f{flash}"]["train_logits"]) < LOGIT_TOL


@pytest.mark.parametrize("flash", [0, 1])
def test_prefill_and_decode_match_reference(ref, base, params, tokens,
                                            flash):
    """The prefill's last logits and cache (``{attn: k, v (n_groups, B,
    C, K, Dh) bf16; mamba: windows bf16, states f32 (L, ...)}``), and one
    decode step from the reference's own cache (``cache_from_jax``), which
    writes the new rows, windows and states in place."""
    model = _model(base, flash)
    before = fa.flash_attention.launches
    last, cache = model.forward_prefill(params, {"tokens": tokens[:, :P]},
                                        C)
    assert fa.flash_attention.launches == before    # CPU: no kernel
    r = ref[f"f{flash}"]
    assert _rel(last, r["prefill_logits"]) < LOGIT_TOL
    got, want = dict(tree_flatten(cache)), dict(tree_flatten(r["cache"]))
    assert sorted(got) == sorted(want)
    for name, t in got.items():
        w = want[name]
        assert t.shape == w.shape and t.dtype == (
            torch.float32 if name.endswith("state") else torch.bfloat16)
        assert _rel(t, w) < LOGIT_TOL, name
    for name in ("attn/k", "attn/v"):     # the first application's rows
        assert (got[name][0].float().numpy() != want[name][0]).mean() \
            < CACHE_DIFFER_FRAC, name
    cache = weights.cache_from_jax(r["cache"], model.cfg, R.LM_BATCH, C,
                                   "cpu")
    ptrs = [t.data_ptr() for t in tree_leaves(cache)]
    logits, new = model.forward_decode(params, cache, tokens[:, P:], P)
    assert new is cache and [t.data_ptr() for t in tree_leaves(cache)] \
        == ptrs
    assert _rel(logits, r["decode_logits"]) < DECODE_TOL
    got, want = dict(tree_flatten(cache)), dict(tree_flatten(
        r["decode_cache"]))
    for name, t in got.items():
        assert _rel(t, want[name]) < DECODE_TOL, name


@pytest.mark.parametrize("flash", [0, 1])
def test_decode_matches_own_full_forward(base, params, tokens, flash):
    """As ``tests/test_serve.py``: prefill + one recurrent decode step ==
    the parallel full forward's next position, within its 3e-2."""
    model = _model(base, flash)
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


@pytest.mark.parametrize("k", range(R.LM_TRAIN_STEPS))
def test_train_step_matches_reference(ref, base, k):
    """``comm='xla'`` LARS steps from the reference's own states: the loss
    and each tensor's new params (``torch_reference.check_train_step``),
    and finite gradients through every Mamba leaf (the momentum, from
    zero at step 0, is the first update)."""
    _, _, _, state = R.check_train_step(ref["train"][f"s{k}"], base,
                                        loss_rtol=LOSS_RTOL,
                                        update_tol=UPDATE_TOL)
    for path, m in tree_flatten(state.mom):
        assert bool(torch.isfinite(m).all()), path
        if k == 0 and "layers/mamba" in path:
            assert float(m.abs().max()) > 0, path


@pytest.mark.parametrize("k", range(R.LM_TRAIN_STEPS))
def test_train_momentum_matches_reference(ref, base, k):
    """The same steps' momentum, each tensor within UPDATE_TOL of the
    reference's largest element of that tensor."""
    r = ref["train"][f"s{k}"]
    *_, state = R.check_train_step(r, base, loss_rtol=LOSS_RTOL,
                                   update_tol=UPDATE_TOL)
    want = dict(tree_flatten(r["out"]["mom"]))
    for path, m in tree_flatten(weights.to_numpy(state.mom)):
        top = np.abs(want[path]).max()
        assert np.abs(m - want[path]).max() <= UPDATE_TOL * top, path


def test_remat_matches_no_remat(base, params, tokens):
    """``cfg.remat`` recomputes each Mamba layer in the backward: the same
    loss and gradients bit for bit."""
    grads = []
    for remat in (False, True):
        model = build_model(dataclasses.replace(base, remat=remat))
        p = {n: t.clone().requires_grad_() for n, t in
             tree_flatten(params)}
        tree = tree_unflatten(list(p), list(p.values()))
        (logits, _), _ = model.forward_train(tree, {"tokens": tokens})
        logits.float().square().mean().backward()
        grads.append({n: t.grad for n, t in p.items()})
    for n in grads[0]:
        assert torch.equal(grads[0][n], grads[1][n]), n


# ---------------------------------------------------------------------------
# serving's bf16 weights and the CLI


def test_pinit_bf16_leaves_equal_the_cast(base):
    """Each bf16 leaf pinit makes equals the cast of its f32 leaf (the
    ``ones`` of A_log, D and the norms, the zeros of dt_bias)."""
    pd = build_model(base).param_pd
    f32 = dict(tree_flatten(pinit.materialize(pd, 7, "cpu")))
    b16 = pinit.materialize(pd, 7, "cpu", dtype=torch.bfloat16)
    for path, leaf in tree_flatten(b16):
        assert leaf.dtype == torch.bfloat16, path
        assert torch.equal(leaf, f32[path].to(torch.bfloat16)), path
    assert bool((b16["layers"]["mamba"]["A_log"] == 1).all())


def test_serve_cli_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.serve.decode", "--arch",
         R.HYBRID_ARCH, "--reduced", "--device", "cpu", "--batch", "2",
         "--max-new", "4", "--flash-attention"], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    assert out.returncode == 0, out.stderr
    assert f"arch={R.HYBRID_ARCH} (reduced)" in out.stdout
    assert "generated (2, 4) tokens" in out.stdout
