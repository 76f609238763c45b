"""The model axis for whisper and the VLM, and for attention heads that
the axis does not divide (ROADMAP §1 item 6.2c), over four gloo ranks
(``torch_ranks.py lm_tp_frames``) against the JAX package's GSPMD program
on Auto-axis meshes of four host devices (``torch_reference.py
tp_frames_cases``: one subprocess, its params placed by their specs).

The reduced whisper-base (its encoder over the stub frames, the decoder's
cross-attention over the encoder's replicated output, the GELU MLP whose
replicated ``b_out`` is added once, after the sum) and internvl2-2b (the
replicated stub projector, the image prefix, the IGNORE-padded labels) at
(data 2, model 2) in bf16 and wholly in f32; the reduced qwen1.5-0.5b
with one kv head over model 2 (MQA) and with two heads over model 4 (half
a head a rank: q, k and v gathered whole, the caches held whole) wholly
in f32. Held against the reference at ``test_torch_tp.py``'s bounds: the
forward's, the prefill's and one decode step's logits, the caches
(gathered over both axes), the greedy tokens (``check_greedy_tokens`` on
each rank's rows; bf16 at the serving margin) and two LARS ``comm='xla'``
steps from the reference's own inputs (loss, masters, momentum). Worst
figures measured here: f32 logits and caches 1.4e-6 of their max, steps
loss 1.4e-7, masters 9.9e-5 of the update, momentum 2.7e-6; bf16 logits
7.8e-3, caches 5.3e-3, steps loss 1.5e-4, masters and momentum 2.0e-2.
Within the port, in f32: model 2 against the port with no mesh (logits,
two steps' masters and momentum; ``test_torch_tp.py``'s bounds), the
replicated masters the same bits on every rank; the CLI with whisper at
``--model-parallel 2``.

Without ranks: whisper's and the VLM's leaves split where the
reference's specs split them, and ``attention.HeadSplit``'s cut gives
every column of o to exactly one rank, each from a head the rank
attends against the kv head its group reads."""
import dataclasses

import numpy as np
import pytest
import torch_ranks
import torch_reference as R

from repro.configs import get_config as jget_config
from repro.models import transformer as jtf
from repro_torch.configs import get_config
from repro_torch.models import attention, transformer
from repro_torch.tree import tree_flatten

#: (logits and caches, loss, masters of the update, momentum):
#: ``test_torch_tp.py``'s bounds
BOUNDS = {1: (1e-5, 1e-6, 5e-4, 1e-5), 0: (3e-2, 4e-4, 5e-2, 5e-2)}
SELF_LOGITS, SELF_UPDATE, SELF_MASTERS = 2e-6, 1e-6, 1e-5


@pytest.fixture(scope="module")
def ref_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ref") / "tp_frames.npz")
    R.run("tp_frames_cases", path, devices=4)
    return path


@pytest.fixture(scope="module")
def ranks(ref_path, tmp_path_factory):
    return torch_ranks.launch(f"lm_tp_frames:{ref_path}", 4,
                              str(tmp_path_factory.mktemp("ranks")),
                              timeout=600)


def _norm(spec):
    spec = tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)
    while spec and spec[-1] is None:
        spec = spec[:-1]
    return spec


@pytest.mark.tier1
@pytest.mark.parametrize("arch", R.TP_FRAMES_ARCHS)
def test_frames_specs_are_the_references(arch):
    """Every leaf of whisper's and the VLM's params and caches is split
    where the reference's ``PD.spec`` splits it."""
    jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
    for jtree, tree in ((jtf.lm_pd(jcfg), transformer.lm_pd(cfg)),
                        (jtf.cache_pd(jcfg, 4, 16),
                         transformer.cache_pd(cfg, 4, 16))):
        want, got = dict(tree_flatten(jtree)), dict(tree_flatten(tree))
        assert set(want) == set(got)
        for path, pd in got.items():
            assert _norm(pd.spec) == _norm(tuple(want[path].spec)), path


@pytest.mark.tier1
@pytest.mark.parametrize("H,K,m", [(4, 1, 2), (2, 2, 4), (6, 2, 4),
                                   (3, 1, 2), (8, 8, 4), (16, 8, 4)])
def test_head_split_covers_every_column_once(H, K, m):
    """Over the m ranks: the o columns each keeps tile ``[0, H·Dh)`` in
    rank order; each lies in a head the rank attends; each attended
    query head reads its group's kv head; the caches are whole exactly
    where m does not divide K."""
    hd = 8
    G = H // K
    cols = []
    for r in range(m):
        hs = attention._head_split(H, K, hd, m, r)
        lo = hs.q_lo * hd + hs.col
        cols.extend(range(lo, lo + hs.w))
        assert hs.q_lo * hd <= lo and lo + hs.w <= hs.q_hi * hd
        kv = (list(range(hs.kv_lo, hs.kv_hi)) if hs.expand is None else
              [hs.kv_lo + e for e in hs.expand])
        n = hs.q_hi - hs.q_lo
        per = n // len(kv) if hs.expand is None else 1
        for j, h in enumerate(range(hs.q_lo, hs.q_hi)):
            assert kv[j // per] == h // G, (r, h)
        assert hs.kv_whole == (K % m != 0)
        assert hs.q_whole == (H % m != 0)
    assert cols == list(range(H * hd))


@pytest.mark.tier1
def test_cache_whole_where_kv_heads_do_not_divide():
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b").reduced(),
                              n_kv_heads=2)
    for m, split in ((1, True), (2, True), (4, False)):
        pd = dict(tree_flatten(transformer.cache_pd(cfg, 2, 8, m)))
        assert all(("model" in x.spec) == split for x in pd.values()), m


# ------------------------------------------------- four gloo ranks


def _each(ranks, key):
    vals = [np.asarray(r[key]) for r in ranks]
    for v in vals[1:]:           # every rank gathered the same outputs
        np.testing.assert_array_equal(v, vals[0])
    return vals[0]


def _held(ranks, pre, f32):
    logits, loss, masters, mom = BOUNDS[f32]
    for name in ("train_logits", "prefill_logits", "decode_logits",
                 "cache", "decode_cache"):
        assert _each(ranks, f"{pre}/{name}") <= logits, name
    d_loss, d_masters, d_mom = _each(ranks, f"{pre}/step")
    assert d_loss <= loss and d_masters <= masters and d_mom <= mom, \
        (d_loss, d_masters, d_mom)


@pytest.mark.tier2
@pytest.mark.parametrize("f32", [0, 1])
@pytest.mark.parametrize("arch", R.TP_FRAMES_ARCHS)
def test_frames_meet_the_reference(ranks, arch, f32):
    """Whisper and the VLM at (data 2, model 2): logits, caches, greedy
    tokens (asserted on each rank) and two LARS steps."""
    _held(ranks, f"{arch}/f{f32}", f32)


@pytest.mark.tier2
@pytest.mark.parametrize("case", list(R.TP_HEAD_CASES))
def test_heads_the_axis_cuts_meet_the_reference(ranks, case):
    """MQA over model 2 and two heads over model 4, in f32."""
    _held(ranks, f"{case}/f1", 1)


@pytest.mark.tier2
@pytest.mark.parametrize("name", [*R.TP_FRAMES_ARCHS, "mqa"])
def test_model_2_equals_model_1_in_f32(ranks, name):
    assert _each(ranks, f"self/{name}/logits") <= SELF_LOGITS
    assert _each(ranks, f"self/{name}/mom") <= SELF_UPDATE
    assert _each(ranks, f"self/{name}/masters") <= SELF_MASTERS


@pytest.mark.tier2
@pytest.mark.parametrize("arch", R.TP_FRAMES_ARCHS)
def test_frames_masters_bit_equal_where_replicated(ranks, arch):
    """At (data 2, model 2), rank ``d·2 + m``: the replicated leaves'
    masters and momentum (the LayerNorms, the positions, ``b_out``, the
    stub projector) are the same bits on every rank; all of a rank's
    shards are its data twin's."""
    rep = [bytes(r[f"self/{arch}/sha_rep"]) for r in ranks]
    both = [bytes(r[f"self/{arch}/sha_all"]) for r in ranks]
    assert len(set(rep)) == 1
    assert both[0] == both[2] and both[1] == both[3] and both[0] != both[1]


@pytest.mark.tier2
def test_frames_pinit_shards_are_the_whole_leaves_slices(ranks):
    """``pinit.materialize(mesh=)``'s owner-draw-and-scatter over
    whisper's and the VLM's trees: each rank's shards equal the whole
    leaves' slices bit for bit, f32 and bf16."""
    assert all(bool(r["pinit"]) for r in ranks)


@pytest.mark.tier2
def test_cli_whisper_over_the_model_axis(ranks):
    assert all(bool(r["cli"]) for r in ranks)
