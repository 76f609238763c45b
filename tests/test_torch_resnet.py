"""The port's ResNet-50 against the JAX package's: convolutions ("SAME"
padding, asymmetric when strided), BatchNorm and the max-pool in f32 to
1e-5; the whole reduced forward and its gradients in bf16 against bounds
measured on this comparison (stated at each assert). The reference's bf16
forward runs in a subprocess with XLA rounding at every operation
(tests/torch_reference.py says why)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_reference

from repro.models import resnet as jr
from repro_torch import weights
from repro_torch.configs import get_config
from repro_torch.core.label_smoothing import smoothed_xent as txent
from repro_torch.core.precision import cast_to_compute as tcast
from repro_torch.models import resnet as tr
from repro_torch.tree import tree_flatten, tree_map

pytestmark = pytest.mark.tier1


def _nchw(x):
    return tr.to_nchw(torch.from_numpy(x))


@pytest.mark.parametrize("k,stride,size", [(7, 2, 32), (7, 2, 15),
                                           (3, 2, 16), (3, 2, 15),
                                           (1, 2, 16), (3, 1, 16),
                                           (1, 1, 9)])
def test_conv_matches_reference_f32(k, stride, size):
    rng = np.random.default_rng(k * 100 + stride * 10 + size)
    x = rng.standard_normal((2, size, size, 5)).astype(np.float32)
    w = rng.standard_normal((k, k, 5, 6)).astype(np.float32)
    want = np.asarray(jr._conv(jnp.asarray(x), jnp.asarray(w), stride))
    got = tr.to_nhwc(tr._conv(_nchw(x), torch.from_numpy(w), stride))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_same_pad_is_asymmetric_where_xla_pads_so():
    assert tr.same_pad(224, 7, 2) == (2, 3)      # the stem
    assert tr.same_pad(56, 3, 2) == (0, 1)       # conv2 of s1b0..s3b0
    assert tr.same_pad(56, 1, 2) == (0, 0)       # proj
    assert tr.same_pad(56, 3, 1) == (1, 1)


@pytest.mark.parametrize("train", [True, False])
def test_bn_matches_reference_f32(train):
    rng = np.random.default_rng(1)
    x = (2 + 3 * rng.standard_normal((4, 6, 6, 8))).astype(np.float32)
    p = {"scale": rng.standard_normal(8).astype(np.float32),
         "bias": rng.standard_normal(8).astype(np.float32)}
    st = {"mean": rng.standard_normal(8).astype(np.float32),
          "var": (1 + rng.random(8)).astype(np.float32)}
    want_y, want_st = jr._bn(jnp.asarray(x), p, st, train=train,
                             momentum=0.9)
    got_y, got_st = tr._bn(_nchw(x), tree_map(torch.from_numpy, p),
                           tree_map(torch.from_numpy, st), train=train,
                           momentum=0.9)
    np.testing.assert_allclose(tr.to_nhwc(got_y).numpy(), np.asarray(want_y),
                               rtol=1e-5, atol=1e-5)
    for k in ("mean", "var"):   # biased batch variance in the running stats
        np.testing.assert_allclose(got_st[k].numpy(), np.asarray(want_st[k]),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("size", [16, 15])
def test_maxpool_matches_reduce_window(size):
    x = np.random.default_rng(size).standard_normal(
        (2, size, size, 4)).astype(np.float32)
    want = jax.lax.reduce_window(jnp.asarray(x), -jnp.inf, jax.lax.max,
                                 (1, 3, 3, 1), (1, 2, 2, 1), "SAME")
    got = tr.to_nhwc(tr._maxpool(_nchw(x)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def reduced_case(tmp_path_factory):
    """The reference's params, BN state and batch for the reduced config,
    its bf16 forward and its gradients w.r.t. the bf16 compute copy."""
    return torch_reference.run(
        "resnet_grads", str(tmp_path_factory.mktemp("ref") / "r.npz"))


def test_reduced_forward_and_grads_match_reference_bf16(reduced_case):
    ref = reduced_case
    params, bn, batch = ref["params"], ref["bn"], ref["batch"]
    want_logits, want_bn, want_g = ref["logits"], ref["new_bn"], ref["grads"]
    cfg = get_config("resnet50").reduced()
    p_in = tree_map(lambda x: x.detach().requires_grad_(),
                    tcast(weights.params_from_jax(params, cfg, "cpu")))
    logits, new_bn = tr.resnet_forward(
        p_in, weights.bn_state_from_jax(bn, cfg, "cpu"), cfg,
        torch.from_numpy(np.array(batch["images"])), train=True)
    loss, _ = txent(logits, torch.from_numpy(np.array(batch["labels"])))
    flat = tree_flatten(p_in)
    grads = torch.autograd.grad(loss, [x for _, x in flat])

    # Bounds measured on this comparison (inputs: tests/torch_reference.py,
    # residual branches damped), each about twice the measurement or more:
    # logits max |diff| 3.7e-7 on values up to 2.0 (the bf16 convolutions
    # agree bit for bit here; the f32 head sums in another order)
    np.testing.assert_allclose(logits.detach().numpy(), want_logits,
                               rtol=0, atol=1e-5)
    # running stats: 6.5e-7 of each tensor's max |value|
    for (path, got), (_, want) in zip(tree_flatten(weights.to_numpy(new_bn)),
                                      tree_flatten(want_bn)):
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), path
    # gradients w.r.t. the bf16 copy: the bf16 backward rounds at other
    # places in XLA and ATen, and the noise grows on the way back to the
    # stem, whose BN-bias gradient sums many cancelling terms. Relative L2
    # error per tensor: worst 0.147 (stem/bn/bias), median 0.005.
    want_g = dict(tree_flatten(want_g))
    errs = {}
    for (path, _), g in zip(flat, grads):
        w = np.asarray(want_g[path], np.float32)
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == w.shape
        errs[path] = (np.linalg.norm(g.float().numpy() - w)
                      / np.linalg.norm(w))
    assert max(errs.values()) <= 0.3, max(errs.items(), key=lambda t: t[1])
    assert np.median(list(errs.values())) <= 0.01, np.median(
        list(errs.values()))
