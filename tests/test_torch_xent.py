"""The LM loss of the port against the JAX package's: K4's plain version
(``kernels/ref.smoothed_xent_rows``, what the wrapper runs on a CPU tensor)
against the Pallas kernel in interpret mode at ``test_kernels.py``'s
(T, V) x ε grid, with the reference's tolerances (1e-5 f32, 2e-2 with bf16
logits); the port's ``_lm_loss`` against ``repro.core.label_smoothing.
smoothed_xent`` with IGNORE rows, its value and its gradient; and the
gradient formula the backward kernel implements against ``jax.grad`` of
the JAX package's plain K4. Inputs are drawn with numpy and go through
both packages. The kernels themselves run on the card
(``test_torch_gpu.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import label_smoothing as jls
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core.label_smoothing import IGNORE
from repro_torch.kernels import ops, ref
from repro_torch.kernels import smoothed_xent as sx
from repro_torch.train.step import _lm_loss

pytestmark = pytest.mark.tier1

#: test_kernels.py::test_smoothed_xent's grid
GRID = [(8, 512), (64, 1000), (128, 4096), (256, 2048), (16, 333)]


def _case(T, V, seed=0):
    rng = np.random.default_rng(T + V + seed)
    logits = (4.0 * rng.standard_normal((T, V))).astype(np.float32)
    labels = rng.integers(0, V, T).astype(np.int32)
    return logits, labels


@pytest.mark.parametrize("T,V", GRID)
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_plain_rows_match_pallas_kernel(T, V, smoothing):
    logits, labels = _case(T, V)
    want = jops.smoothed_xent_rows(jnp.asarray(logits), jnp.asarray(labels),
                                   smoothing)
    before = sx.smoothed_xent_rows_forward.launches
    got = ops.smoothed_xent_rows(torch.from_numpy(logits),
                                 torch.from_numpy(labels), smoothing)
    assert sx.smoothed_xent_rows_forward.launches == before     # CPU: no kernel
    assert got.dtype == torch.float32 and got.shape == (T,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_plain_rows_bf16_logits_match_pallas_kernel():
    """As ``test_kernels.py::test_smoothed_xent_bf16_logits``: bf16 logits
    in, f32 rows out, 2e-2."""
    logits, labels = _case(32, 512, seed=9)
    lt = torch.from_numpy(logits).bfloat16()
    want = jops.smoothed_xent_rows(jnp.asarray(lt.float().numpy(),
                                               jnp.bfloat16),
                                   jnp.asarray(labels), 0.1)
    got = ops.smoothed_xent_rows(lt, torch.from_numpy(labels), 0.1)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-2,
                               atol=2e-2)


def test_ignore_label_takes_no_target_as_the_kernel():
    """A label outside [0, V) hits no column of the Pallas kernel (its
    ``cols == labels`` test): the plain version gives the same rows."""
    logits, labels = _case(16, 333)
    labels[::3] = IGNORE
    labels[1] = 333
    want = jops.smoothed_xent_rows(jnp.asarray(logits), jnp.asarray(labels),
                                   0.1)
    got = ref.smoothed_xent_rows(torch.from_numpy(logits),
                                 torch.from_numpy(labels), smoothing=0.1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def _lm_case():
    rng = np.random.default_rng(3)
    logits = (3 * rng.standard_normal((3, 10, 257))).astype(np.float32)
    labels = rng.integers(0, 257, (3, 10)).astype(np.int32)
    labels[rng.random((3, 10)) < 0.3] = IGNORE
    labels[:, -1] = IGNORE          # token_batch's last column
    return logits, labels


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_lm_loss_matches_reference_smoothed_xent(smoothing):
    """The loss and n_valid to 1e-6 (measured 1.1e-7 relative); the
    gradient w.r.t. the logits against ``jax.grad`` of the reference's loss
    to 1e-6 of its max (measured 4.5e-7), masked rows exactly 0 in
    both."""
    logits, labels = _lm_case()
    jloss = lambda x: jls.smoothed_xent(x, jnp.asarray(labels),
                                        smoothing=smoothing)
    (want, want_n) = jloss(jnp.asarray(logits))
    want_g = np.asarray(jax.grad(lambda x: jloss(x)[0])(jnp.asarray(logits)))
    x = torch.from_numpy(logits).requires_grad_()
    got, got_n = _lm_loss(x, torch.from_numpy(labels), smoothing=smoothing)
    (got_g,) = torch.autograd.grad(got, x)
    assert int(got_n) == int(want_n)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(got_g.numpy(), want_g, rtol=1e-6,
                               atol=1e-6 * np.abs(want_g).max())
    masked = labels == IGNORE
    assert not got_g.numpy()[masked].any() and not want_g[masked].any()


def test_lm_loss_refuses_prefix_labels():
    """The VLM image prefix (labels narrower than the logits; ported with
    the VLM family): the labels are left-padded with IGNORE over the
    prefix, as the reference's ``train.step._lm_loss`` pads them, so the
    loss and its count equal the reference's and the loss with the labels
    padded by hand."""
    from repro.train.step import _lm_loss as j_lm_loss
    rng = np.random.default_rng(7)
    logits = (4.0 * rng.standard_normal((2, 8, 16))).astype(np.float32)
    labels = rng.integers(0, 16, (2, 5)).astype(np.int32)
    labels[:, -1] = IGNORE
    loss, n = _lm_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                       smoothing=0.1)
    want, want_n = j_lm_loss(jnp.asarray(logits), jnp.asarray(labels),
                             smoothing=0.1)
    assert int(n) == int(want_n) == 8
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-6)
    padded = np.concatenate([np.full((2, 3), IGNORE, np.int32), labels], 1)
    assert float(_lm_loss(torch.from_numpy(logits), torch.from_numpy(padded),
                          smoothing=0.1)[0]) == float(loss)


def test_backward_formula_matches_autograd_of_plain():
    """What ``csrc/smoothed_xent.cu``'s backward computes,
    ``g·(exp(x - lse) - (1-ε)·[v = y] - ε/V)`` with a zero row where g is
    0, against ``jax.grad`` of the JAX package's plain K4
    (``repro.kernels.ref.smoothed_xent_rows``) under the same g, at f32
    rtol 1e-5 with an atol of 1e-7 per unit of g (the kernel's bound on
    the card). IGNORE rows go to the reference with label 0, as
    ``_lm_loss`` clamps them: their g is 0, so the label does not count."""
    logits, labels = _case(16, 333)
    labels[::4] = IGNORE
    eps, V = 0.1, logits.shape[1]
    g = np.random.default_rng(5).random(16).astype(np.float32)
    g[labels == IGNORE] = 0.0
    g[1::5] = 0.0
    safe = np.where(labels == IGNORE, 0, labels)
    want = np.asarray(jax.grad(lambda x: jnp.sum(jnp.asarray(g) * jref.
        smoothed_xent_rows(x, jnp.asarray(safe), smoothing=eps)))(
            jnp.asarray(logits)))
    xd = torch.from_numpy(logits).double()
    lse = torch.logsumexp(xd, dim=-1, keepdim=True)
    hit = torch.arange(V)[None] == torch.from_numpy(labels).long()[:, None]
    got = (torch.from_numpy(g).double()[:, None]
           * (torch.exp(xd - lse) - (1 - eps) * hit - eps / V)).float()
    err = np.abs(got.numpy() - want)
    assert (err <= 1e-7 * g[:, None] + 1e-5 * np.abs(want)).all()
    assert not got.numpy()[g == 0].any() and not want[g == 0].any()


def test_wrapper_has_no_kernel_off_the_card():
    """Neither the CPU nor any other device reaches the kernel by another
    road: the meta device raises."""
    x = torch.empty(4, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel for meta"):
        ops.smoothed_xent_rows(x, torch.zeros(4, dtype=torch.int32,
                                              device="meta"))
    with pytest.raises(ValueError, match="no kernel for meta"):
        sx.smoothed_xent_rows_backward(x, torch.zeros(4, device="meta"),
                                       torch.zeros(4, device="meta"),
                                       torch.zeros(4, device="meta"), 0.1)
