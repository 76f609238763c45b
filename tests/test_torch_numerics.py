"""Parity of the port's small numerics with the JAX package: LR schedules,
label-smoothed cross entropy, top-1 accuracy. Inputs come from numpy with
a fixed seed and go through both packages."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import label_smoothing as jls
from repro.core import schedule as jsched
from repro_torch.core import label_smoothing as tls
from repro_torch.core import schedule as tsched

pytestmark = pytest.mark.tier1

DECAYS = ("const", "step", "linear", "poly2", "cosine")


@pytest.mark.parametrize("decay", DECAYS)
@pytest.mark.parametrize("warmup", [0, 7])
def test_schedule_matches_reference(decay, warmup):
    kw = dict(base_lr=3.2, warmup_steps=warmup, total_steps=100, decay=decay)
    ref = jsched.make_schedule(jsched.ScheduleConfig(**kw))
    port = tsched.make_schedule(tsched.ScheduleConfig(**kw))
    want = np.asarray([ref(s) for s in range(110)], np.float32)
    got = np.asarray([port(s) for s in range(110)], np.float32)
    if decay == "cosine":
        # torch.cos and jnp.cos round differently by one ulp (2^-23 at
        # most on [-1, 1]); the (base-end)/2 factor carries it into the
        # result, plus one rounding of the result itself. Near the end of
        # the decay 1+cos cancels, so this is up to 13 ulp of the result.
        tol = 0.5 * (kw["base_lr"] - 1e-4) * 2 ** -23 + np.spacing(want)
        assert np.all(np.abs(got - want) <= tol)
    else:
        np.testing.assert_array_equal(got, want)


def test_linear_scaled_lr_matches_reference():
    for batch in (8, 256, 81_920):
        assert (tsched.linear_scaled_lr(0.1, batch)
                == jsched.linear_scaled_lr(0.1, batch))


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_smoothed_xent_with_ignore(smoothing):
    rng = np.random.default_rng(0)
    logits = (3 * rng.standard_normal((4, 6, 37))).astype(np.float32)
    labels = rng.integers(0, 37, (4, 6)).astype(np.int32)
    labels[rng.random((4, 6)) < 0.3] = jls.IGNORE
    want, want_n = jls.smoothed_xent(jnp.asarray(logits), jnp.asarray(labels),
                                     smoothing=smoothing)
    got, got_n = tls.smoothed_xent(torch.from_numpy(logits),
                                   torch.from_numpy(labels),
                                   smoothing=smoothing)
    assert int(got_n) == int(want_n)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6)


def test_top1_accuracy_with_ignore():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((64, 10)).astype(np.float32)
    labels = np.argmax(logits, -1).astype(np.int32)
    labels[::3] = (labels[::3] + 1) % 10        # a third are misses
    labels[::5] = jls.IGNORE
    want = jls.top1_accuracy(jnp.asarray(logits), jnp.asarray(labels))
    got = tls.top1_accuracy(torch.from_numpy(logits),
                            torch.from_numpy(labels))
    assert float(got) == pytest.approx(float(want), abs=1e-7)
