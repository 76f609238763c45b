"""Language-model composition: the decoder family (dense and MoE, with
GQA or MLA attention; the prefix VLM, internvl2, whose stub patch
embeddings go through a stub projector ahead of the tokens), the hybrid
(zamba2: Mamba2 layers with a shared attention block), the xLSTM stack
and the encoder-decoder (whisper: stub audio frames through an encoder,
cross-attended by the decoder).

Layer parameters are stacked along a leading layer axis, as in the JAX
package, so one descriptor tree and one set of weights mean the same model
in both; the xLSTM stack, heterogeneous, keeps one ``layer_XX`` subtree a
layer, as the JAX package does. The JAX package scans the stacks with
``lax.scan``; the port walks them with a Python loop over views of the
stacked leaves, and writes the stacked caches in place.

Three entry points, as the JAX package has them: ``forward_train`` (full
logits and the MoE aux loss summed over the layers, differentiable; with
``cfg.remat`` each decoder or Mamba layer is recomputed in the backward,
as the JAX package wraps its layer scans in ``jax.checkpoint``, and each
application of the hybrid's shared block too),
``forward_prefill`` (logits of the last position + a filled cache) and
``forward_decode`` (one token against the cache, updated in place).

Each entry point takes ``mesh`` (a ``launch.mesh`` mesh, as the
reference's take a ``jax.sharding.Mesh``). Over its ``model`` axis
(ROADMAP §1 items 6.2, 6.2b, 6.2c and 6.3's experts and MLA: the dense
decoder, the MoE decoder with GQA or MLA, the hybrid, the xLSTM stack,
whisper and the VLM; ``tp_axis`` refuses ``fsdp`` over data ranks) the
params are a rank's
shards by their specs, the batch is the rows of the rank's data index
(the same on every model rank of a data row), and the logits come back
whole over the vocabulary on every model rank: the vocab-split logits (an untied ``lm_head``'s columns, a tied
``embed``'s rows) are gathered, as K4 and the greedy argmax read whole
rows. The tied embedding's lookup zeroes the rows outside the rank's
vocabulary slice and sums over the axis; the untied one's (d split)
gathers its columns. Whisper's encoder runs on every model rank alike
(its heads and FFN columns split as the decoder's), its replicated output
entering each cross-attention through ``copy_in``, so the encoder's
gradient sums over the axis; the LayerNorms, the learned positions and the
VLM's stub projector are replicated.
"""
from __future__ import annotations

import functools
import types
from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.precision import compute_dtype
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mb
from repro_torch.models import mlp as mlpm
from repro_torch.models import moe as moem
from repro_torch.models import xlstm as xl
from repro_torch.models.common import PD, copy_in, dense_pd, gather_out, \
    layer_norm, local_slice, model_axis, not_ported, pd_stack, reduce_out, \
    rms_norm, uneven_split
from repro_torch.tree import tree_flatten, tree_map

MAX_POS = 32_768   # learned-position table size (whisper-style decoders)


# ---------------------------------------------------------------------------
# parameter descriptor trees


def _attn_pd(cfg):
    return attn.mla_pd(cfg) if cfg.mla is not None else attn.gqa_pd(cfg)


def _dense_layer_pd(cfg):
    d = cfg.d_model
    p = {"ln1": PD((d,), init="ones"), "attn": _attn_pd(cfg),
         "ln2": PD((d,), init="ones")}
    if cfg.moe is not None:
        p["moe"] = moem.moe_pd(cfg)
        if cfg.moe.n_shared:
            p["shared"] = mlpm.swiglu_pd(
                cfg, d_ff=cfg.moe.n_shared * cfg.moe.d_expert)
    else:
        p["mlp"] = mlpm.swiglu_pd(cfg)
    return p


def _whisper_layer_pd(cfg, cross: bool):
    d = cfg.d_model
    p = {"ln1": PD((d,), init="ones"), "ln1b": PD((d,), init="zeros"),
         "attn": attn.gqa_pd(cfg),
         "ln2": PD((d,), init="ones"), "ln2b": PD((d,), init="zeros"),
         "mlp": mlpm.gelu_mlp_pd(cfg)}
    if cross:
        p["lnx"] = PD((d,), init="ones")
        p["lnxb"] = PD((d,), init="zeros")
        p["cross"] = attn.gqa_pd(cfg)
    return p


def lm_pd(cfg) -> Dict[str, Any]:
    d, V = cfg.d_model, cfg.vocab_size
    dp = "data" if cfg.fsdp else None
    # tied: the vocabulary splits (it is also the head's columns); untied:
    # d splits, and the head's vocabulary
    tree: Dict[str, Any] = {
        "final_norm": PD((d,), init="ones"),
        "embed": PD((V, d), spec=("model", dp) if cfg.tie_embeddings
                    else (dp, "model"), scale=0.02)}
    if not cfg.tie_embeddings:
        tree["lm_head"] = dense_pd(d, V, spec=(dp, "model"),
                                   scale=d ** -0.5)
    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        tree["layers"] = pd_stack(_dense_layer_pd(cfg), cfg.n_layers)
        if fam == "vlm":
            tree["proj"] = dense_pd(d, d)   # stub projector
    elif fam == "ssm" and cfg.xlstm is not None:
        for i in range(cfg.n_layers):
            blk = (xl.mlstm_pd(cfg) if xl.block_kind(cfg, i) == "m"
                   else xl.slstm_pd(cfg))
            tree[f"layer_{i:02d}"] = {"ln": PD((d,), init="ones"),
                                      "blk": blk}
    elif fam == "hybrid":
        tree["layers"] = pd_stack(
            {"ln": PD((d,), init="ones"), "mamba": mb.mamba_pd(cfg)},
            cfg.n_layers)
        tree["shared_attn"] = {
            "ln1": PD((d,), init="ones"), "attn": attn.gqa_pd(cfg),
            "ln2": PD((d,), init="ones"), "mlp": mlpm.swiglu_pd(cfg)}
    elif fam == "audio":
        enc = cfg.encoder
        tree["enc_pos"] = PD((enc.n_frames, d), scale=0.02)
        tree["enc_layers"] = pd_stack(_whisper_layer_pd(cfg, cross=False),
                                      enc.n_layers)
        tree["enc_norm"] = PD((d,), init="ones")
        tree["enc_norm_b"] = PD((d,), init="zeros")
        tree["dec_pos"] = PD((MAX_POS, d), scale=0.02)
        tree["layers"] = pd_stack(_whisper_layer_pd(cfg, cross=True),
                                  cfg.n_layers)
        tree["final_norm_b"] = PD((d,), init="zeros")
    else:
        raise ValueError(fam)
    return tree


def cache_pd(cfg, batch: int, max_seq: int, m: int = 1):
    """Descriptor tree of what forward_prefill produces: stacked bf16
    (L, batch, max_seq, K, Dh) k and v (the MoE family's too); with MLA,
    the stacked bf16 latent ``ckv`` (L, batch, max_seq, kv_lora_rank) and
    rope key ``krope`` (L, batch, max_seq, rope_head_dim). The hybrid:
    ``attn``, the shared block's k and v stacked over its applications
    (n_groups, batch, max_seq, K, Dh), and ``mamba``, the Mamba layers'
    conv windows (bf16) and states (f32) stacked over the layers. The
    xLSTM stack: a ``layer_XX`` tree a layer, mLSTM's C, n, m or sLSTM's
    c, n, h, m, all f32. The VLM's rows hold its image prefix first, so
    max_seq counts it. Whisper: ``self``, the decoder's k and v, and
    ``cross``, the encoder output's (L, batch, n_frames, K, Dh), bf16.
    Every leaf's spec is the reference's: the k and v caches split their
    heads over ``model`` (``P(dp, None, "model", None)``), and so do the
    Mamba layers' ``conv_x`` and ``state``; MLA's latent and rope key
    (``P(dp, None, None)``) and the xLSTM's states are whole on every
    model rank, and so are the k and v caches at ``m`` model ranks where
    m does not divide the kv heads (``attention.HeadSplit``; the
    reference's spec holds at the default m = 1). The batch is a rank's
    own rows."""
    split = "model" if cfg.n_kv_heads % m == 0 else None
    heads = lambda *shape: PD(shape, spec=("data", None, split, None),
                              init="zeros", dtype=torch.bfloat16)
    if cfg.family == "ssm":
        return {f"layer_{i:02d}": (xl.mlstm_cache_pd(cfg, batch)
                                   if xl.block_kind(cfg, i) == "m"
                                   else xl.slstm_cache_pd(cfg, batch))
                for i in range(cfg.n_layers)}
    if cfg.mla is not None:
        m = cfg.mla
        whole = lambda *shape: PD(shape, spec=("data", None, None),
                                  init="zeros", dtype=torch.bfloat16)
        return pd_stack({"ckv": whole(batch, max_seq, m.kv_lora_rank),
                         "krope": whole(batch, max_seq, m.rope_head_dim)},
                        cfg.n_layers)
    kv_of = lambda rows: {n: heads(batch, rows, cfg.n_kv_heads,
                                    cfg.resolved_head_dim) for n in "kv"}
    if cfg.family == "audio":
        return pd_stack({"self": kv_of(max_seq),
                         "cross": kv_of(cfg.encoder.n_frames)}, cfg.n_layers)
    kv = kv_of(max_seq)
    if cfg.family == "hybrid":
        return {"attn": pd_stack(kv, len(_hybrid_groups(cfg))),
                "mamba": pd_stack(mb.mamba_cache_pd(cfg, batch),
                                  cfg.n_layers)}
    return pd_stack(kv, cfg.n_layers)


# ---------------------------------------------------------------------------
# shared pieces


def tp_axis(cfg, mesh):
    """The model axis (``launch.mesh.Axis``) the forward over ``mesh``
    splits ``cfg``'s leaves over, None where it spans one rank. Every LM
    family splits (items 6.2, 6.2b, 6.2c; the MoE layer's experts and MLA,
    item 6.3). Refuses what the port does not split yet: ``fsdp`` over
    more than one data rank, at any M (item 6.3); MLA's heads that M does
    not divide (item 6.3c); the xLSTM's heads that M does not divide (item
    6.2d: the sLSTM's block-diagonal recurrence would split inside a
    head); and a leaf that M does not divide, which the reference cannot
    place either (``common.uneven_split``; the expert stacks pad to a
    multiple of 16). GQA heads that M does not divide where the leaves do
    (K < M among them) are gathered (``attention.HeadSplit``). Nothing
    falls back."""
    if cfg.fsdp and mesh is not None and any(
            a.size > 1 for a in mesh.axes if a.name != "model"):
        raise not_ported(f"{cfg.arch_id}: fsdp (the masters split over "
                         f"data) with more than one data rank", "6.3")
    tp = model_axis(mesh)
    if tp is None:
        return None
    _check_splits(cfg, tp.size)
    return tp


@functools.lru_cache(maxsize=64)
def _check_splits(cfg, m: int):
    """Every split leaf of ``cfg`` divides over ``m`` model ranks (else
    ``uneven_split``), and so do MLA's heads (else item 6.3c: a rank's
    columns would cut a head) and the xLSTM's (else item 6.2d)."""
    axis = types.SimpleNamespace(size=m, index=0)
    for path, pd in tree_flatten(lm_pd(cfg)):
        try:
            local_slice(pd, axis)
        except NotImplementedError:
            raise uneven_split(f"{cfg.arch_id}: {path} {tuple(pd.shape)}",
                               m) from None
    if cfg.mla is not None and cfg.n_heads % m:
        raise not_ported(f"{cfg.arch_id}: MLA's n_heads={cfg.n_heads} over "
                         f"model={m} (a rank's columns cutting a head)",
                         "6.3c")
    if cfg.xlstm is not None and cfg.n_heads % m:
        raise not_ported(f"{cfg.arch_id}: the xLSTM's n_heads={cfg.n_heads} "
                         f"over model={m} (the sLSTM's block-diagonal "
                         f"recurrence split inside a head)", "6.2d")


def _embed(params, cfg, tokens, tp=None):
    """The token embeddings in the compute dtype; over the model axis
    ``tp``, the rank's vocabulary rows (tied: out-of-slice tokens give
    zero rows, then the sum over the axis) or d columns (untied: gathered
    over the axis)."""
    dt = compute_dtype()
    e = params["embed"]
    if tp is None:
        return e[tokens].to(dt)
    if not cfg.tie_embeddings:
        return gather_out(e[tokens].to(dt), tp)
    rows = e.shape[0]
    local = tokens - tp.index * rows
    ok = (local >= 0) & (local < rows)
    x = e[torch.where(ok, local, 0)].to(dt)
    return reduce_out(torch.where(ok[..., None], x, x.new_zeros(())), tp)


def _inputs(params, cfg, batch, tp=None):
    """The decoder stack's input (B, S, d): the token embeddings, after
    the VLM's image prefix (its patch embeddings through the stub
    projector, in the compute dtype, as the JAX package rounds them). The
    projector is replicated over the model axis ``tp`` and reads the
    replicated frames: its gradient is every rank's alike, not summed."""
    x = _embed(params, cfg, batch["tokens"], tp)
    if cfg.family == "vlm":
        dt = compute_dtype()
        x = torch.cat([batch["frames"].to(dt) @ params["proj"].to(dt), x],
                      dim=1)
    return x


def _logits(params, cfg, x, tp=None):
    """f32 logits over the whole vocabulary; over the model axis ``tp``
    the rank's vocabulary slice, gathered."""
    x = (layer_norm(x, params["final_norm"], params["final_norm_b"])
         if cfg.family == "audio"
         else rms_norm(x, params["final_norm"], cfg.rms_eps))
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return gather_out(copy_in(x, tp) @ w.to(x.dtype), tp).float()


def _layer(layers, i: int):
    """Layer i's parameters: views into the stacked leaves."""
    return tree_map(lambda a: a[i], layers)


def _put(stacked, n: int, i: int, cache):
    """Layer i's cache tree written into ``stacked``, whose leaves (n, ...)
    are allocated at the first write. Returns ``stacked``."""
    if stacked is None:
        stacked = tree_map(lambda t: t.new_empty((n, *t.shape)), cache)
    for (_, dst), (_, t) in zip(tree_flatten(stacked), tree_flatten(cache)):
        dst[i] = t
    return stacked


def _run(fn, remat: bool, *args):
    """``fn(*args)``, recomputed in the backward when ``remat``: a layer
    draws no random numbers, so no RNG state needs keeping."""
    if remat:
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


def _walk(layer, layers, n: int, x, cfg, *args, train: bool):
    """x through ``layer(p, x, cfg, *args) -> x`` for each of the n
    stacked layers; in training each is recomputed in the backward under
    ``cfg.remat`` (the JAX package's checkpointed layer scan). The stacked
    leaves are unbound once: their backward is one stack of the n layer
    gradients, not a zero-filled full-size gradient a layer as slicing
    each layer out would give."""
    unbound = tree_map(lambda a: a.unbind(0), layers)
    remat = train and cfg.remat and torch.is_grad_enabled()
    for i in range(n):
        x = _run(layer, remat, tree_map(lambda t: t[i], unbound), x, cfg,
                 *args)
    return x


# ---------------------------------------------------------------------------
# dense / MoE decoder


def _dense_block(p, x, positions, cfg, *, decode=False, cache=None,
                 pos=None, cache_len=0, tp=None):
    """One decoder layer. Returns (x, aux, new_cache); aux is the MoE
    layer's load-balance loss, None for a dense layer. ``tp``: the model
    axis (GQA or MLA, the SwiGLU and the experts)."""
    h = rms_norm(x, p["ln1"], cfg.rms_eps)
    if cfg.mla is not None:
        if decode:
            a, new_cache = attn.mla_decode(p["attn"], h, pos, cfg, cache,
                                           tp=tp)
        else:
            a, new_cache = attn.mla_parallel(p["attn"], h, positions, cfg,
                                             cache_len=cache_len, tp=tp)
    elif decode:
        a, new_cache = attn.gqa_decode(p["attn"], h, pos, cfg, cache, tp=tp)
    else:
        a, new_cache = attn.gqa_parallel(p["attn"], h, positions, cfg,
                                         cache_len=cache_len, tp=tp)
    x = x + a
    h = rms_norm(x, p["ln2"], cfg.rms_eps)
    aux = None
    if cfg.moe is not None:
        m, aux = moem.moe_apply(p["moe"], h, cfg, decode=decode, tp=tp)
        if cfg.moe.n_shared:
            m = m + mlpm.swiglu_apply(p["shared"], h, tp)
    else:
        m = mlpm.swiglu_apply(p["mlp"], h, tp)
    return x + m, aux, new_cache


def _train_block(p, x, positions, cfg, tp):
    return _dense_block(p, x, positions, cfg, tp=tp)[:2]


def _add(total, a):
    """Running sum of the layers' aux (None: a dense stack, no aux)."""
    return a if total is None else total + a


def _dense_forward(params, cfg, x, positions, *, mode, cache=None, pos=None,
                   cache_len=0, tp=None):
    """mode: train | prefill | decode. x: embedded inputs (B,S,d). Returns
    (x, aux, cache): aux summed over the layers (None for a dense stack);
    the decode cache is the given one, updated in place. ``tp``: the
    model axis (``tp_axis``)."""
    L = cfg.n_layers
    aux = None
    if mode == "train":
        # unbound once, as in _walk
        unbound = tree_map(lambda a: a.unbind(0), params["layers"])
        remat = cfg.remat and torch.is_grad_enabled()
        for i in range(L):
            x, a = _run(_train_block, remat, tree_map(lambda t: t[i],
                                                      unbound),
                        x, positions, cfg, tp)
            aux = _add(aux, a)
        return x, aux, None
    if mode == "prefill":
        stacked = None
        for i in range(L):
            x, a, c = _dense_block(_layer(params["layers"], i), x,
                                   positions, cfg, cache_len=cache_len, tp=tp)
            aux = _add(aux, a)
            stacked = _put(stacked, L, i, c)
        return x, aux, stacked
    for i in range(L):
        x, a, _ = _dense_block(_layer(params["layers"], i), x, None, cfg,
                               decode=True, cache=_layer(cache, i), pos=pos,
                               tp=tp)
        aux = _add(aux, a)
    return x, aux, cache


# ---------------------------------------------------------------------------
# hybrid (zamba2): Mamba layers in groups, the shared attention block
# applied before each group


def _shared_attn_block(p, x, positions, cfg, *, decode=False, cache=None,
                       pos=None, cache_len=0, tp=None):
    h = rms_norm(x, p["ln1"], cfg.rms_eps)
    if decode:
        a, c = attn.gqa_decode(p["attn"], h, pos, cfg, cache, tp=tp)
    else:
        a, c = attn.gqa_parallel(p["attn"], h, positions, cfg,
                                 cache_len=cache_len, tp=tp)
    x = x + a
    h = rms_norm(x, p["ln2"], cfg.rms_eps)
    return x + mlpm.swiglu_apply(p["mlp"], h, tp), c


def _hybrid_groups(cfg):
    k = cfg.attn_every
    n = cfg.n_layers
    return [(g * k, min((g + 1) * k, n)) for g in range(-(-n // k))]


def _mamba_layer(p, x, cfg, tp):
    """One Mamba layer of the training forward, with its residual."""
    o, _ = mb.mamba_parallel(p["mamba"], rms_norm(x, p["ln"], cfg.rms_eps),
                             cfg, tp=tp)
    return x + o


def _shared_train_block(p, x, positions, cfg, tp):
    return _shared_attn_block(p, x, positions, cfg, tp=tp)[0]


def _hybrid_forward(params, cfg, x, positions, *, mode, cache=None,
                    pos=None, cache_len=0, tp=None):
    """As ``_dense_forward``, for the hybrid: each group of ``attn_every``
    Mamba layers follows an application of the shared block. Under
    ``cfg.remat`` the Mamba layers are recomputed in the backward, as in
    the JAX package, and so is each application of the shared block,
    which the JAX package keeps: the same values, and at zamba2-7b's full
    width an application keeps ~4.7 GB for its backward at one 4,096-token
    sequence (mostly attention probabilities), ~66 GB over the 14 of its
    full depth. The prefill's cache is allocated at its first write;
    decode's is updated in place. ``tp``: the model axis (the shared
    block's heads and FFN, the Mamba layers' SSM heads)."""
    layers, shared = params["layers"], params["shared_attn"]
    groups = _hybrid_groups(cfg)
    if mode == "train":
        # unbound once, as in _walk; the shared leaves read once, here,
        # not inside a recomputed application
        unbound = tree_map(lambda a: a.unbind(0), layers)
        shared = tree_map(lambda a: a, shared)
        remat = cfg.remat and torch.is_grad_enabled()
    elif mode == "prefill":
        cache = {"attn": None, "mamba": None}
    for g, (lo, hi) in enumerate(groups):
        if mode == "decode":
            x, _ = _shared_attn_block(shared, x, None, cfg, decode=True,
                                      cache=_layer(cache["attn"], g),
                                      pos=pos, tp=tp)
        elif mode == "train":
            x = _run(_shared_train_block, remat, shared, x, positions, cfg,
                     tp)
        else:
            x, c = _shared_attn_block(shared, x, positions, cfg,
                                      cache_len=cache_len, tp=tp)
            cache["attn"] = _put(cache["attn"], len(groups), g, c)
        for i in range(lo, hi):
            if mode == "train":
                x = _run(_mamba_layer, remat,
                         tree_map(lambda t: t[i], unbound), x, cfg, tp)
                continue
            p = _layer(layers, i)
            h = rms_norm(x, p["ln"], cfg.rms_eps)
            if mode == "prefill":
                o, c = mb.mamba_parallel(p["mamba"], h, cfg,
                                         return_cache=True, tp=tp)
                cache["mamba"] = _put(cache["mamba"], cfg.n_layers, i, c)
            else:
                o, _ = mb.mamba_decode(p["mamba"], h, cfg,
                                       _layer(cache["mamba"], i), tp)
            x = x + o
    return x, None, (None if mode == "train" else cache)


# ---------------------------------------------------------------------------
# xLSTM stack (heterogeneous: one subtree a layer)


def _xlstm_forward(params, cfg, x, positions, *, mode, cache=None, pos=None,
                   cache_len=0, tp=None):
    """As ``_dense_forward``, for the xLSTM stack (no positions: the
    recurrences carry them); the prefill's cache is a ``layer_XX`` tree of
    the blocks' final states, decode's updated in place. ``tp``: the
    model axis (``models/xlstm.py``)."""
    if mode == "prefill":
        cache = {}
    for i in range(cfg.n_layers):
        key = f"layer_{i:02d}"
        p = params[key]
        m = xl.block_kind(cfg, i) == "m"
        h = rms_norm(x, p["ln"], cfg.rms_eps)
        if mode == "decode":
            fn = xl.mlstm_decode if m else xl.slstm_decode
            o, _ = fn(p["blk"], h, cfg, cache[key], tp)
        else:
            fn = xl.mlstm_parallel if m else xl.slstm_parallel
            o, c = fn(p["blk"], h, cfg, return_cache=mode == "prefill",
                      tp=tp)
            if mode == "prefill":
                cache[key] = c
        x = x + o
    return x, None, (None if mode == "train" else cache)


# ---------------------------------------------------------------------------
# whisper: encoder over the stub frames, decoder with cross-attention


def _enc_layer(p, x, cfg, tp=None):
    """One encoder layer: non-causal self-attention without rope (the
    JAX package's ``gqa_parallel(..., cross_x=h)``) and the GELU MLP,
    each after a LayerNorm; over the model axis ``tp`` on the rank's heads
    and FFN columns."""
    h = layer_norm(x, p["ln1"], p["ln1b"])
    a, _ = attn.gqa_parallel(p["attn"], h, None, cfg, cross_x=h, tp=tp)
    x = x + a
    h = layer_norm(x, p["ln2"], p["ln2b"])
    return x + mlpm.gelu_mlp_apply(p["mlp"], h, tp)


def _whisper_layer(p, x, positions, cfg, enc_out, *, decode=False,
                   cache=None, pos=None, cache_len=0, tp=None):
    """One decoder layer: causal self-attention, cross-attention over the
    encoder's output and the GELU MLP, each after a LayerNorm. Returns (x,
    cache|None); the prefill's cache holds ``self`` (cache_len rows) and
    ``cross`` (the encoder output's k and v); decode writes its token's
    row of ``self`` in place and reads ``cross``. ``tp``: the model
    axis."""
    h = layer_norm(x, p["ln1"], p["ln1b"])
    if decode:
        a, sc = attn.gqa_decode(p["attn"], h, pos, cfg, cache["self"],
                                tp=tp)
    else:
        a, sc = attn.gqa_parallel(p["attn"], h, positions, cfg,
                                  cache_len=cache_len, tp=tp)
    x = x + a
    a, xc = _cross_attention(p, layer_norm(x, p["lnx"], p["lnxb"]), cfg,
                             enc_out, decode=decode, cache=cache, pos=pos,
                             cache_len=cache_len, tp=tp)
    x = x + a
    h = layer_norm(x, p["ln2"], p["ln2b"])
    x = x + mlpm.gelu_mlp_apply(p["mlp"], h, tp)
    return x, ({"self": sc, "cross": xc} if cache_len or decode else None)


def _cross_attention(p, h, cfg, enc_out, *, decode, cache, pos, cache_len,
                     tp=None):
    """The decoder layer's cross-attention over the encoder's output: its
    k and v cached (``cross``) when the prefill keeps a cache; decode reads
    that cache. Over the model axis ``tp`` the replicated ``enc_out``
    enters through ``copy_in`` (``attention._qkv``)."""
    if decode:
        return attn.gqa_decode(p["cross"], h, pos, cfg, cache["cross"],
                               cross=True, tp=tp)
    return attn.gqa_parallel(p["cross"], h, None, cfg, cross_x=enc_out,
                             cache_len=enc_out.shape[1] if cache_len else 0,
                             tp=tp)


def _dec_train_layer(p, x, cfg, positions, enc_out, tp):
    return _whisper_layer(p, x, positions, cfg, enc_out, tp=tp)[0]


def _whisper_encode(params, cfg, frames, train: bool, tp=None):
    """frames: the stub (B, n_frames, d) embeddings; with the learned
    positions, in the compute dtype, through the encoder layers and the
    final LayerNorm (every model rank of ``tp`` alike)."""
    dt = compute_dtype()
    x = frames.to(dt) + params["enc_pos"].to(dt)
    x = _walk(_enc_layer, params["enc_layers"], cfg.encoder.n_layers, x,
              cfg, tp, train=train)
    return layer_norm(x, params["enc_norm"], params["enc_norm_b"])


def _whisper_forward(params, cfg, tokens, frames, *, mode, cache=None,
                     pos=None, cache_len=0, tp=None):
    """The encoder over ``frames`` (train, prefill) and the decoder over
    ``tokens`` with learned positions. Returns (x, cache): the prefill's
    stacked ``self`` and ``cross`` caches, allocated at the first write;
    decode's the given one, updated in place. ``tp``: the model axis."""
    dt = compute_dtype()
    layers, L = params["layers"], cfg.n_layers
    if mode == "decode":
        x = _embed(params, cfg, tokens, tp) + params["dec_pos"][pos].to(dt)
        for i in range(L):
            x, _ = _whisper_layer(_layer(layers, i), x, None, cfg, None,
                                  decode=True, cache=_layer(cache, i),
                                  pos=pos, tp=tp)
        return x, cache
    enc_out = _whisper_encode(params, cfg, frames, mode == "train", tp)
    S = tokens.shape[1]
    x = _embed(params, cfg, tokens, tp) + params["dec_pos"][:S].to(dt)
    positions = torch.arange(S, device=x.device)[None]
    if mode == "train":
        return _walk(_dec_train_layer, layers, L, x, cfg, positions,
                     enc_out, tp, train=True), None
    stacked = None
    for i in range(L):
        x, c = _whisper_layer(_layer(layers, i), x, positions, cfg, enc_out,
                              cache_len=cache_len, tp=tp)
        stacked = _put(stacked, L, i, c)
    return x, stacked


def _forward(cfg, tp=None):
    """The family's stack: (params, cfg, x, positions, mode=..., ...) ->
    (x, aux, cache), over the model axis ``tp``."""
    fn = {"hybrid": _hybrid_forward, "ssm": _xlstm_forward}.get(
        cfg.family, _dense_forward)
    return functools.partial(fn, tp=tp)


# ---------------------------------------------------------------------------
# public entry points


def _check_tokens(cfg, tp, s: int):
    """A MoE train or prefill over ``s`` tokens a row splits them over the
    model axis ``tp`` where s >= M (``moe._a2a``): refused before any
    collective where M does not divide s, as the reference cannot shard
    that length either."""
    if cfg.moe is not None and tp is not None and s >= tp.size \
            and s % tp.size:
        raise moem.uneven_tokens(cfg.arch_id, s, tp.size)


def forward_train(params, cfg, batch, mesh=None):
    """batch: {'tokens': (B,S)[, 'frames': (B,P,d)]}. Returns (logits
    (B,S',V) f32, aux 0-d f32: the MoE load-balance loss summed over the
    layers, 0 for a dense stack); S' = P + S for the VLM, whose image
    prefix takes P positions, else S. ``mesh``: see the module's
    docstring."""
    tp = tp_axis(cfg, mesh)
    _check_tokens(cfg, tp, batch["tokens"].shape[1])
    if cfg.family == "audio":
        x, _ = _whisper_forward(params, cfg, batch["tokens"],
                                batch["frames"], mode="train", tp=tp)
        aux = None
    else:
        x = _inputs(params, cfg, batch, tp)
        positions = torch.arange(x.shape[1], device=x.device)[None]
        x, aux, _ = _forward(cfg, tp)(params, cfg, x, positions,
                                      mode="train")
    if aux is None:
        aux = torch.zeros((), device=x.device)
    return _logits(params, cfg, x, tp), aux


def forward_prefill(params, cfg, batch, cache_len: int, mesh=None):
    """Returns (last-position logits (B,1,V) f32, cache)."""
    tp = tp_axis(cfg, mesh)
    _check_tokens(cfg, tp, batch["tokens"].shape[1])
    if cfg.family == "audio":
        x, cache = _whisper_forward(params, cfg, batch["tokens"],
                                    batch["frames"], mode="prefill",
                                    cache_len=cache_len, tp=tp)
    else:
        x = _inputs(params, cfg, batch, tp)
        positions = torch.arange(x.shape[1], device=x.device)[None]
        x, _, cache = _forward(cfg, tp)(params, cfg, x, positions,
                                        mode="prefill", cache_len=cache_len)
    return _logits(params, cfg, x[:, -1:], tp), cache


def forward_decode(params, cfg, cache, token, pos: int, mesh=None):
    """token: (B,1) integers; pos: its index (Python int; the VLM's counts
    its image prefix). Returns (logits (B,1,V) f32, cache); the cache is
    updated in place."""
    tp = tp_axis(cfg, mesh)
    if cfg.family == "audio":
        x, cache = _whisper_forward(params, cfg, token, None, mode="decode",
                                    cache=cache, pos=pos, tp=tp)
    else:
        x = _embed(params, cfg, token, tp)
        x, _, cache = _forward(cfg, tp)(params, cfg, x, None, mode="decode",
                                        cache=cache, pos=pos)
    return _logits(params, cfg, x, tp), cache
