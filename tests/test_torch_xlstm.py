"""The port's xLSTM blocks (``models/xlstm.py``: mLSTM and sLSTM) and the
xLSTM LM (the reduced xlstm-125m at 8 layers, so that layer 6 is the
pattern's sLSTM block: d 256, 4 heads, mLSTM heads of 128 (proj 2), sLSTM
heads of 64, chunk 16; vocab 512) against the JAX package's, on the
reference's own numpy inputs (``tests/torch_reference.py xlstm_cases``:
one subprocess, ``mesh=None``, XLA rounding at every bf16 operation).

The modules: ``mlstm_parallel`` with and without a cache at 32 and 33
tokens in f32 (33: the largest divisor chunk, 11, with a cache; zero
padding without) and at 32 in bf16, ``slstm_parallel`` at 32, and both
decodes from the reference's caches, in place; in f32 within 1e-5 of each
output's max (measured 1.3e-6), in bf16 within 2e-2 (measured 3.6e-3); the
f32 gradients at 32 tokens leaf by leaf, each within 1e-5 of its own
largest (measured 4.3e-6, mLSTM's b_f), save the sLSTM input gate's bias,
whose gradient vanishes in exact arithmetic (a shift of that gate at every
step scales c and n alike and cancels in h = o · c / n; the reference's
reads 1.6e-8 of the tree's largest): there both sides must hold no more
than rounding (``torch_reference.leaf_grad_errors``).

The LM. Wholly in f32 (``torch_reference._lm_f32_case``, 33 tokens, so
the zero-padded chunks too), logits within 2e-4 of their max and each
leaf's gradient within 2e-4 of its own largest (measured 2.1e-5 and
1.1e-4), save layer 6's b_i (8.4e-11 of the tree's largest): each block
agrees to the order of f32 sums, and the 8-layer stack grows a difference
from layer to layer. In bf16 a block parts from the reference by its bf16
roundings (its projections' bf16 matmuls round apart here and there, and
the recurrences spread each flip along the sequence: 3.6e-3 of the
module's max), which the stack grows to 3.7e-2 of the logits' max and
3.3e-2 of the prefill's; so these are held to 5e-2 (the reference's own
bound between these blocks' two forms, ``tests/test_models.py``), not to
1e-2; the first layer's cache to 2e-2 and the deeper layers' to 0.1
(measured 1.3e-3 and up to 5.9e-2); one decode step from the reference's
cache to 1e-2 (measured: equal); greedy tokens (equal up to a tie within
that 5e-2); the decode against the port's own full forward to 3e-2
(measured 5.3e-3). Two ``comm='xla'`` LARS steps from the reference's
states, wholly in f32 on both sides (``comm_dtype='f32'`` and
``precision.f32_compute``): the loss within 1e-5 relative (measured 1.4e-7
and 2.8e-7), each tensor's new params within 1e-2 of its largest update
(measured 1.5e-3, layer 6's b_i, stepped by its weight decay) and its
momentum within 1e-2 of its largest (measured 1.1e-4). In bf16 the same
steps part 77 of the 103 tensors' updates from the reference's by more
than 5e-2 of their largest (up to 0.38, layer 7's b_f), the stack's
roundings and not a fault: the f32 steps and gradients above hold each
tensor."""
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
from repro.models import transformer as jtf
from repro.models import xlstm as jxl
from repro_torch import weights
from repro_torch.configs import get_config, param_count
from repro_torch.core import pinit
from repro_torch.models import transformer as ttf
from repro_torch.models import xlstm as xl
from repro_torch.models.registry import build_model
from repro_torch.serve.decode import generate
from repro_torch.tree import tree_flatten, tree_leaves

pytestmark = pytest.mark.tier1

#: module outputs and states in f32: the f32 sums in another order
OUT_TOL_F32 = 1e-5
#: module outputs in bf16: two libraries' bf16 roundings
OUT_TOL_BF16 = 2e-2
#: the f32 module gradients, each leaf of its own largest
GRAD_TOL = 1e-5
#: the f32 LM's logits, and each leaf's gradient (the module docstring)
LM_F32_TOL = 2e-4
#: the leaves whose gradients vanish in exact arithmetic (the sLSTM input
#: gate's bias): ``torch_reference.leaf_grad_errors`` holds them to zero
ZERO_GRAD = {"mlstm": [], "slstm": ["b_i"], "lm": ["layer_06/blk/b_i"]}
#: the bf16 LM's logits and prefill against the reference's
LOGIT_TOL = 5e-2
#: the prefill's cache: the first layer's, and the deeper layers'
CACHE_TOL_FIRST, CACHE_TOL = 2e-2, 0.1
DECODE_TOL = 1e-2
#: decode against the port's own full forward (tests/test_serve.py)
SELF_DECODE_TOL = 3e-2
#: the f32 training steps: the loss, relative; each tensor's new params,
#: of its largest update, and its momentum, of its largest
LOSS_RTOL, UPDATE_TOL = 1e-5, 1e-2
P, C, NEW = R.LM_PROMPT, R.LM_CACHE, R.LM_NEW
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = ["float32", "bfloat16"]
#: (block, its parallel form, its decode, the lengths of its module case)
BLOCKS = {"mlstm": (xl.mlstm_parallel, xl.mlstm_decode, R.SSM_LENGTHS),
          "slstm": (xl.slstm_parallel, xl.slstm_decode, R.SSM_LENGTHS[:1])}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: the suite runs six workers on the CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(2, before))
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return R.run("xlstm_cases", str(tmp_path_factory.mktemp("ref") /
                                    "xlstm.npz"))


@pytest.fixture(scope="module")
def base():
    return R.xlstm_config(get_config)


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
    """Field for field, full, reduced and at the parity depth;
    ``param_count`` is the reference's rough accounting (6 d^2 a layer),
    the tree holds 198.7 M; layer 6 of the parity depth is sLSTM."""
    got, want = get_config(R.XLSTM_ARCH), jget_config(R.XLSTM_ARCH)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(got.reduced()) == \
        dataclasses.asdict(want.reduced())
    assert dataclasses.asdict(R.xlstm_config(get_config)) == \
        dataclasses.asdict(R.xlstm_config(jget_config))
    assert param_count(got) == jparam_count(want) == 119_734_272
    assert sum(int(np.prod(pd.shape))
               for pd in tree_leaves(ttf.lm_pd(got))) == 198_740_056
    kinds = "".join(xl.block_kind(R.xlstm_config(get_config), i)
                    for i in range(R.XLSTM_LAYERS))
    assert kinds == "mmmmmmsm"


@pytest.mark.parametrize("which", ["mlstm_pd", "slstm_pd", "lm_pd",
                                   "cache_pd"])
@pytest.mark.parametrize("reduced", [True, False])
def test_descriptors_equal_the_reference(which, reduced):
    """Paths, shapes, initializers (b_f's const 3.0, the cache's m at
    -1e30), scales and dtypes: each block's, the LM's ``layer_XX`` trees
    and the cache's."""
    if reduced:
        cfg, jcfg = R.xlstm_config(get_config), R.xlstm_config(jget_config)
    else:
        cfg, jcfg = get_config(R.XLSTM_ARCH), jget_config(R.XLSTM_ARCH)
    got, want = {
        "mlstm_pd": lambda: (xl.mlstm_pd(cfg), jxl.mlstm_pd(jcfg)),
        "slstm_pd": lambda: (xl.slstm_pd(cfg), jxl.slstm_pd(jcfg)),
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
# the blocks


def _module(ref, name, dt):
    return {n: _t(v, dt) for n, v in ref[name]["params"].items()}


def _assert_close(got, want, dt, what):
    tol = OUT_TOL_F32 if dt == "float32" else OUT_TOL_BF16
    assert got.shape == want.shape, what
    assert _rel(got, want) <= tol, (what, _rel(got, want))


#: (dtype, block, length): f32 at every length, bf16 at the first
_CASES = [(dt, name, S) for name, (_, _, lengths) in BLOCKS.items()
          for dt in DTYPES
          for S in (lengths if dt == "float32" else lengths[:1])]


@pytest.mark.parametrize("dt,name,S", _CASES)
def test_parallel_form_matches_reference(ref, base, dt, name, S):
    """The output with a cache and without, and the cache (f32 states)."""
    fn = BLOCKS[name][0]
    p, x = _module(ref, name, dt), _t(ref[name][f"x{S}"], dt)
    want = ref[name][dt][f"s{S}"]
    out, cache = fn(p, x, base, return_cache=True)
    out_nc, none = fn(p, x, base)
    assert none is None and out.dtype == x.dtype
    _assert_close(out, want["out"], dt, "out")
    _assert_close(out_nc, want["out_nc"], dt, "out without cache")
    assert sorted(cache) == sorted(want["cache"])
    for n, t in cache.items():
        assert t.dtype == torch.float32
        _assert_close(t, want["cache"][n], dt, n)


@pytest.mark.parametrize("name,S", [(name, lengths[0]) for name, (
    _, _, lengths) in BLOCKS.items()])
def test_f32_gradients_match_reference(ref, base, name, S):
    """The f32 gradients of the parallel form (no cache) with respect to
    every param and the input, leaf by leaf
    (``torch_reference.module_grads_error``)."""
    err, path, zero = R.module_grads_error(BLOCKS[name][0], ref, name, S,
                                           base)
    assert err <= GRAD_TOL, (path, err)
    assert zero == ZERO_GRAD[name]


@pytest.mark.parametrize("name", list(BLOCKS))
@pytest.mark.parametrize("dt", DTYPES)
def test_decode_matches_reference_in_place(ref, base, dt, name):
    """One step from the reference's 32-token cache: the output and the
    new states, written into the given cache's storage."""
    p, x = _module(ref, name, dt), _t(ref[name]["x_dec"], dt)
    r = ref[name][dt]
    cache = {n: _t(v, "float32") for n, v in r["s32"]["cache"].items()}
    ptrs = {n: t.data_ptr() for n, t in cache.items()}
    out, new = BLOCKS[name][1](p, x, base, cache)
    assert new is cache
    assert {n: t.data_ptr() for n, t in cache.items()} == ptrs
    _assert_close(out, r["decode"]["out"], dt, "out")
    for n, t in cache.items():
        _assert_close(t, r["decode"]["cache"][n], dt, n)


# ---------------------------------------------------------------------------
# the xLSTM LM


def test_f32_lm_and_gradients_match_reference(ref, base):
    """The xLSTM LM wholly in f32, forward and backward, each leaf's
    gradient against its own largest (``torch_reference.lm_f32_errors``)."""
    d_logits, err, path, zero = R.lm_f32_errors(base, ref)
    assert d_logits <= LM_F32_TOL
    assert err <= LM_F32_TOL, (path, err)
    assert zero == ZERO_GRAD["lm"]


def test_forward_train_matches_reference(ref, base, params, tokens):
    (logits, aux), _ = build_model(base).forward_train(
        params, {"tokens": tokens})
    assert logits.dtype == torch.float32 and float(aux) == 0.0
    assert _rel(logits, ref["f0"]["train_logits"]) < LOGIT_TOL


def test_prefill_and_decode_match_reference(ref, base, params, tokens):
    """The prefill's last logits and its ``layer_XX`` cache (mLSTM's C, n,
    m; layer 6's sLSTM c, n, h, m), and one decode step from the
    reference's own cache (``cache_from_jax``), in place."""
    model = build_model(base)
    last, cache = model.forward_prefill(params, {"tokens": tokens[:, :P]},
                                        C)
    r = ref["f0"]
    assert _rel(last, r["prefill_logits"]) < LOGIT_TOL
    assert sorted(cache["layer_06"]) == ["c", "h", "m", "n"]
    got, want = dict(tree_flatten(cache)), dict(tree_flatten(r["cache"]))
    assert sorted(got) == sorted(want)
    for name, t in got.items():
        assert t.dtype == torch.float32 and t.shape == want[name].shape
        tol = CACHE_TOL_FIRST if name.startswith("layer_00") else CACHE_TOL
        assert _rel(t, want[name]) < tol, name
    cache = weights.cache_from_jax(r["cache"], base, R.LM_BATCH, C, "cpu")
    ptrs = [t.data_ptr() for t in tree_leaves(cache)]
    logits, new = model.forward_decode(params, cache, tokens[:, P:], P)
    assert new is cache and [t.data_ptr() for t in tree_leaves(cache)] \
        == ptrs
    assert _rel(logits, r["decode_logits"]) < DECODE_TOL
    want = dict(tree_flatten(r["decode_cache"]))
    for name, t in tree_flatten(cache):
        assert _rel(t, want[name]) < DECODE_TOL, name


def test_decode_matches_own_full_forward(base, params, tokens):
    """As ``tests/test_serve.py``: prefill + one recurrent decode step ==
    the parallel full forward's next position, within its 3e-2."""
    model = build_model(base)
    (full, _), _ = model.forward_train(params, {"tokens": tokens})
    _, cache = model.forward_prefill(params, {"tokens": tokens[:, :P]}, C)
    dl, _ = model.forward_decode(params, cache, tokens[:, P:], P)
    assert _rel(dl[:, 0], full[:, -1].numpy()) < SELF_DECODE_TOL


def test_generate_matches_reference_tokens(ref, base, params, tokens):
    """Greedy tokens equal the reference's up to a tie within the logits'
    bound, LOGIT_TOL of their max (``torch_reference.check_greedy_tokens``
    with that margin: one bf16 ulp is below the 8-layer stack's measured
    differences)."""
    model = build_model(base)
    out = generate(model, params, {"tokens": tokens[:, :P]}, max_new=NEW,
                   cache_len=C)
    assert out.dtype == torch.int32 and out.shape == (R.LM_BATCH, NEW)
    R.check_greedy_tokens(model, params, tokens[:, :P],
                          ref["f0"]["generate"], out.numpy(), C,
                          rel_margin=LOGIT_TOL)


@pytest.mark.parametrize("k", range(R.LM_TRAIN_STEPS))
def test_train_step_matches_reference(ref, base, k):
    """``comm='xla'`` LARS steps from the reference's own states, wholly
    in f32 (``torch_reference.check_train_step``): the loss and each
    tensor's new params; every momentum leaf finite, and nonzero at step 0
    in every sLSTM leaf (the time loop's backward reaches them all)."""
    *_, state = R.check_train_step(ref["train"][f"s{k}"], base,
                                   loss_rtol=LOSS_RTOL,
                                   update_tol=UPDATE_TOL, f32=True)
    for path, m in tree_flatten(state.mom):
        assert bool(torch.isfinite(m).all()), path
        if k == 0 and path.startswith("layer_06/blk/"):
            assert float(m.abs().max()) > 0, path


@pytest.mark.parametrize("k", range(R.LM_TRAIN_STEPS))
def test_train_momentum_matches_reference(ref, base, k):
    """The same f32 steps' momentum, each tensor within UPDATE_TOL of the
    reference's largest element of that tensor."""
    r = ref["train"][f"s{k}"]
    *_, state = R.check_train_step(r, base, loss_rtol=LOSS_RTOL,
                                   update_tol=UPDATE_TOL, f32=True)
    want = dict(tree_flatten(r["out"]["mom"]))
    for path, m in tree_flatten(weights.to_numpy(state.mom)):
        top = np.abs(want[path]).max()
        assert np.abs(m - want[path]).max() <= UPDATE_TOL * top, path


# ---------------------------------------------------------------------------
# serving's bf16 weights and the CLI


def test_pinit_bf16_leaves_equal_the_cast(base):
    """Each bf16 leaf pinit makes equals the cast of its f32 leaf (b_f's
    const 3.0, the norms' ones, the zeros of the other biases)."""
    pd = build_model(base).param_pd
    f32 = dict(tree_flatten(pinit.materialize(pd, 7, "cpu")))
    b16 = pinit.materialize(pd, 7, "cpu", dtype=torch.bfloat16)
    for path, leaf in tree_flatten(b16):
        assert leaf.dtype == torch.bfloat16, path
        assert torch.equal(leaf, f32[path].to(torch.bfloat16)), path
    assert bool((b16["layer_06"]["blk"]["b_f"] == 3).all())
    assert bool((b16["layer_00"]["blk"]["b_f"] == 3).all())


def test_serve_cli_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.serve.decode", "--arch",
         R.XLSTM_ARCH, "--reduced", "--device", "cpu", "--batch", "2",
         "--max-new", "4"], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env=dict(os.environ,
                              PYTHONPATH=os.path.join(ROOT, "src")))
    assert out.returncode == 0, out.stderr
    assert f"arch={R.XLSTM_ARCH} (reduced)" in out.stdout
    assert "generated (2, 4) tokens" in out.stdout
