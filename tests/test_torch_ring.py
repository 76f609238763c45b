"""The ring-step fold of the port against the JAX package's: K3's plain
version (``kernels/ref.ring_add_step``, what the wrapper runs on a CPU
tensor, and what ``comm.ring_kernel.kernel_step_fn`` folds with there)
against the Pallas kernel ``repro.comm.ring_kernel.ring_add_step`` in
interpret mode, at the shapes of ``test_comm.py``'s ring-kernel tests: f32
(4, 2·1024) at k 0 and 3, bf16 ones + 0.5, and the four ragged (n, length)
pairs viewed through ``_as_chunks(pad_to=CHUNK)`` at every k. One add per
element, rounded once, in both: bit for bit (rtol 0, atol 0), stricter
than the reference's rtol 1e-6. Inputs are drawn with numpy and go through
both packages; the kernel itself runs on the card (``test_torch_gpu.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import primitives as jprim
from repro.comm.ring_kernel import ring_add_step as pallas_ring_add_step
from repro_torch.comm import primitives as prim
from repro_torch.comm import ring_kernel
from repro_torch.core.bucketing import CHUNK
from repro_torch.kernels import ref

pytestmark = pytest.mark.tier1

#: test_comm.py::test_ring_kernel_parity_ragged_buckets
RAGGED = [(2, 1000), (3, 5000), (4, 4096), (8, 33000)]


def _both(recv, chunks, k):
    """(port's fold through the wrapper, the Pallas kernel's) as numpy."""
    before = ring_kernel.ring_add_step.launches
    got = ring_kernel.ring_add_step(torch.from_numpy(recv),
                                    torch.from_numpy(chunks), k)
    assert ring_kernel.ring_add_step.launches == before   # CPU: no kernel
    want = pallas_ring_add_step(jnp.asarray(recv), jnp.asarray(chunks),
                                jnp.int32(k), interpret=True)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("k", [0, 3])
def test_plain_fold_matches_pallas_kernel_f32(k):
    rng = np.random.default_rng(0)
    chunks = rng.standard_normal((4, 2 * CHUNK)).astype(np.float32)
    recv = rng.standard_normal(2 * CHUNK).astype(np.float32)
    got, want = _both(recv, chunks, k)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=0)
    np.testing.assert_array_equal(got, recv + chunks[k])


def test_plain_fold_matches_pallas_kernel_bf16():
    chunks = torch.ones((2, CHUNK), dtype=torch.bfloat16)
    recv = torch.full((CHUNK,), 0.5, dtype=torch.bfloat16)
    got = ring_kernel.ring_add_step(recv, chunks, 1)
    assert got.dtype == torch.bfloat16
    want = pallas_ring_add_step(jnp.full((CHUNK,), 0.5, jnp.bfloat16),
                                jnp.ones((2, CHUNK), jnp.bfloat16),
                                jnp.int32(1), interpret=True)
    assert want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=0, atol=0)
    np.testing.assert_array_equal(got.float().numpy(), 1.5)


def test_plain_fold_matches_pallas_kernel_bf16_random():
    """bf16 sums that round: both add in f32 and round once."""
    rng = np.random.default_rng(5)
    c = torch.from_numpy(rng.standard_normal((3, 2 * CHUNK))
                         .astype(np.float32)).bfloat16()
    r = torch.from_numpy(rng.standard_normal(2 * CHUNK)
                         .astype(np.float32)).bfloat16()
    for k in range(3):
        got = ring_kernel.ring_add_step(r, c, k)
        want = pallas_ring_add_step(
            jnp.asarray(r.float().numpy(), jnp.bfloat16),
            jnp.asarray(c.float().numpy(), jnp.bfloat16), jnp.int32(k),
            interpret=True)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))


@pytest.mark.parametrize("n,length", RAGGED)
def test_plain_fold_matches_pallas_kernel_ragged(n, length):
    """The zero-padded chunk view the ring schedules feed the fold, at
    every chunk index; the port's and the reference's ``_as_chunks`` cut
    the same rows."""
    rng = np.random.default_rng(17 * n + length)
    x = rng.standard_normal(length).astype(np.float32)
    chunks = prim._as_chunks(torch.from_numpy(x), n, pad_to=CHUNK)
    jchunks = jprim._as_chunks(jnp.asarray(x), n, pad_to=CHUNK)
    assert tuple(chunks.shape) == tuple(jchunks.shape)
    np.testing.assert_array_equal(chunks.numpy(), np.asarray(jchunks))
    c = chunks.shape[1]
    assert c % CHUNK == 0 and n * c >= length
    recv = rng.standard_normal(c).astype(np.float32)
    step = ring_kernel.kernel_step_fn()
    for k in range(n):
        got, want = _both(recv, chunks.numpy(), k)
        np.testing.assert_allclose(got, want, rtol=0, atol=0)
        # the adapter folds in place into a receive buffer it owns
        buf = torch.from_numpy(recv.copy())
        out = step(buf, chunks, k)
        assert out is buf
        np.testing.assert_array_equal(out.numpy(), got)
        np.testing.assert_array_equal(
            ref.ring_add_step(torch.from_numpy(recv), chunks, k).numpy(),
            got)


def test_wrapper_rejects_bad_inputs_on_cpu():
    chunks = torch.zeros((2, CHUNK))
    recv = torch.zeros(CHUNK)
    with pytest.raises(ValueError, match="k must be"):
        ring_kernel.ring_add_step(recv, chunks, 2)
    with pytest.raises(ValueError, match="c %"):
        ring_kernel.ring_add_step(recv[:1000], chunks[:, :1000], 0)
    with pytest.raises(TypeError, match="chunks are"):
        ring_kernel.ring_add_step(recv.bfloat16(), chunks, 0)
    # the caller's recv is left alone unless it is the out buffer
    r = torch.ones(CHUNK)
    ring_kernel.ring_add_step(r, torch.ones((2, CHUNK)), 0)
    assert bool((r == 1).all())


def test_step_fn_checks_every_fold():
    """The adapter checks a chunks buffer in full on its first fold; later
    folds against it still reject a bad k or a receive of another shape
    or dtype."""
    chunks = torch.zeros((2, CHUNK))
    step = ring_kernel.kernel_step_fn()
    step(torch.zeros(CHUNK), chunks, 0)
    with pytest.raises(ValueError, match="k must be"):
        step(torch.zeros(CHUNK), chunks, 2)
    with pytest.raises(ValueError, match="recv has shape"):
        step(torch.zeros(2 * CHUNK), chunks, 1)
    with pytest.raises(TypeError, match="chunks are"):
        step(torch.zeros(CHUNK, dtype=torch.bfloat16), chunks, 1)
    assert step(torch.ones(CHUNK), chunks, 1).sum().item() == CHUNK


def test_step_fn_rebinds_on_a_new_chunks():
    """One adapter folding against one chunks buffer, then a second (the
    fold binds to each anew), then the first again: every fold is the
    Pallas kernel's bit for bit; after a rebind a mismatched receive
    still raises the wrapper's messages."""
    rng = np.random.default_rng(23)
    a = rng.standard_normal((3, 2 * CHUNK)).astype(np.float32)
    b = rng.standard_normal((2, CHUNK)).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    step = ring_kernel.kernel_step_fn()
    for chunks, tchunks, k in ((a, ta, 2), (a, ta, 0), (b, tb, 1),
                               (b, tb, 0), (a, ta, 1)):
        recv = rng.standard_normal(chunks.shape[1]).astype(np.float32)
        _, want = _both(recv, chunks, k)
        buf = torch.from_numpy(recv.copy())
        assert step(buf, tchunks, k) is buf
        np.testing.assert_array_equal(buf.numpy(), want)
    with pytest.raises(ValueError, match="recv has shape"):
        step(torch.zeros(CHUNK), ta, 1)
    with pytest.raises(ValueError, match="k must be"):
        step(torch.zeros(2 * CHUNK), ta, 3)
    with pytest.raises(TypeError, match="chunks are"):
        step(torch.zeros(2 * CHUNK, dtype=torch.bfloat16), ta, 1)
    with pytest.raises(ValueError, match="contiguous"):
        step(torch.zeros(4 * CHUNK)[::2], ta, 1)
