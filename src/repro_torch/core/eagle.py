"""EAGLE-3 draft model, chain and tree drafting (port of
``repro/core/eagle.py``).

One decoder layer + LM head over the target's concatenated low/mid/high
capture features (3·D, fused to D) and the embedding of the most recent
token; during chain drafting the draft's own hidden state stands in for
the target feature.  The draft shares the target's token embedding.

The draft cache is a dense dict ``{"k", "v": (B, max_len, Hk, D),
"lengths", "pad"}``, or a paged one (``init_draft_cache(...,
page_size=P)``) whose ``k``/``v`` are ``(NP + 1, P, Hk, D)`` page pools
read and written through its own ``tbl`` copy of the block table.
``draft_extend`` / ``draft_propose`` write their K/V rows into it in place
(JAX donates the buffers) and return a new dict with the advanced
lengths.  Refill seeding (one-shot, or chunk by chunk with
``seed_chunk_pairs``) runs on a dense R-row staging cache, which
``scatter_draft_rows_paged`` then writes through the table.  Drafting is
greedy or sampled with JAX's threefry keys (``kernels/sample``).
``draft_train_loss`` is the EAGLE-3 training loss,
differentiable through the prefill kernel and its backward kernel.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.linear_rows.ops import linear_rows
from repro_torch.kernels.sample import ops as sample
from repro_torch.models import attention as attn
from repro_torch.models.config import ATTN, FFN_SWIGLU, BlockDef, ModelConfig
from repro_torch.models.layers import (EMBED, MLP, embed, ffn, ffn_specs,
                                       rmsnorm, rmsnorm_specs)
from repro_torch.models.param import (ParamSpec, ParamTree, count_params,
                                      init_params)

NEG_INF = -1e30          # the reference's masked-logit value


def draft_config(tcfg: ModelConfig) -> ModelConfig:
    """Draft architecture derived from the target: 1 decoder layer, same
    d_model/vocab, small GQA."""
    bound = max(min(tcfg.num_heads, tcfg.d_model // 64), 1)
    heads = next(h for h in range(bound, 0, -1) if tcfg.d_model % h == 0)
    kv = min(tcfg.num_kv_heads, heads)
    while heads % kv:
        kv -= 1
    return dataclasses.replace(
        tcfg,
        name=tcfg.name + "-eagle3",
        family="dense",
        num_layers=1,
        prologue=(),
        pattern=(BlockDef(ATTN, FFN_SWIGLU),),
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=tcfg.d_model // heads,
        d_ff=2 * tcfg.d_model,
        num_experts=0,
        experts_per_tok=0,
        num_shared_experts=0,
        encoder_layers=0,
        num_image_tokens=0,
        q_lora_rank=0,
        kv_lora_rank=0,
        window=0,
        capture_layers=(0, 0, 0),
    )


def draft_specs(dcfg: ModelConfig) -> dict:
    d, v = dcfg.d_model, dcfg.vocab_size
    return {
        "fuse": ParamSpec((3 * d, d), (MLP, EMBED)),
        "fc": ParamSpec((2 * d, d), (MLP, EMBED)),
        "norm1": rmsnorm_specs(d),
        "attn": attn.attn_specs(dcfg),
        "norm2": rmsnorm_specs(d),
        "ffn": ffn_specs(dcfg, FFN_SWIGLU),
        "final_norm": rmsnorm_specs(d),
        "head": {"w": ParamSpec((d, v), (EMBED, "vocab"))},
    }


def draft_init(dcfg: ModelConfig, seed: int = 0, *, device) -> ParamTree:
    """Random draft weights from a seeded ``torch.Generator``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return ParamTree(init_params(draft_specs(dcfg), gen, device,
                                 dcfg.act_dtype))


def draft_param_count(dcfg: ModelConfig) -> int:
    return count_params(draft_specs(dcfg))


# ------------------------------------------------------------ core layer
def _layer(dcfg: ModelConfig, p, x, k_cache, v_cache, lengths, pad,
           page_tbl=None, linear=torch.matmul):
    """One decoder layer over new positions (decode form, in-place cache
    write; through ``page_tbl`` for a paged draft cache).  ``linear``
    computes the attention's projections."""
    h = rmsnorm(p["norm1"], x, dcfg.norm_eps)
    out, _ = attn.self_attention_decode(dcfg, p["attn"], h, k_cache, v_cache,
                                        lengths, pad, page_tbl=page_tbl,
                                        linear=linear)
    x = x + out
    h2 = rmsnorm(p["norm2"], x, dcfg.norm_eps)
    return x + ffn(p["ffn"], h2)


def _layer_full(dcfg: ModelConfig, p, x):
    """Training form: full causal self-attention over the window, no
    cache (``attention.self_attention_train``: the prefill kernel, with
    the backward kernel as its gradient)."""
    h = rmsnorm(p["norm1"], x, dcfg.norm_eps)
    x = x + attn.self_attention_train(dcfg, p["attn"], h)
    h2 = rmsnorm(p["norm2"], x, dcfg.norm_eps)
    return x + ffn(p["ffn"], h2)


def _head(dcfg, dparams, x):
    return (x @ dparams["head"]["w"]).float()


def _fuse_inputs(dcfg, dparams, feats, tok_emb, linear=torch.matmul):
    """feats: (B,T,3D) target captures (or (B,T,D) self features);
    tok_emb: (B,T,D).  Returns fc([fused; emb]).  The 3D→D fuse is the
    sum of three D-contraction products, one per capture level, as in
    the reference; ``linear`` computes the products."""
    dt = tok_emb.dtype
    d = dcfg.d_model
    if feats.shape[-1] == 3 * d:
        w = dparams["fuse"]
        f = feats.to(dt)
        fused = sum(linear(f[..., i * d:(i + 1) * d], w[i * d:(i + 1) * d])
                    for i in range(3))
    else:
        fused = feats.to(dt)
    x = torch.cat([fused, tok_emb], dim=-1)
    return linear(x, dparams["fc"])


# ------------------------------------------------------------- cache
def init_draft_cache(dcfg: ModelConfig, batch: int, max_len: int, *,
                     device, page_size: int = 0, num_pages: int = 0) -> dict:
    """Zeroed draft cache.  With ``page_size > 0`` the K/V leaves are page
    pools (num_pages + 1, P, Hk, D) with a ``tbl`` (batch, max_len // P)
    of trash entries: the same layout as the target's pools, with a
    table copy of its own (JAX donates the two caches separately)."""
    hk, hd = dcfg.num_kv_heads, dcfg.head_dim
    z = dict(dtype=dcfg.act_dtype, device=device)
    cache = {
        "lengths": torch.zeros((batch,), dtype=torch.int32, device=device),
        "pad": torch.zeros((batch,), dtype=torch.int32, device=device),
    }
    shape = (batch, max_len, hk, hd)
    if page_size > 0:
        if max_len % page_size:
            raise ValueError(f"max_len {max_len} % page_size {page_size}")
        cache["tbl"] = torch.full((batch, max_len // page_size), num_pages,
                                  dtype=torch.int32, device=device)
        shape = (num_pages + 1, page_size, hk, hd)
    cache["k"] = torch.zeros(shape, **z)
    cache["v"] = torch.zeros(shape, **z)
    return cache


# ------------------------------------------------------- serving functions
def draft_extend(dcfg: ModelConfig, dparams, embed_params, dcache, feats,
                 tokens, advance, linear=torch.matmul):
    """Append ``T`` (feature, token) pairs to the draft cache.

    feats: (B, T, 3D) target captures; tokens: (B, T) the tokens
    following each feature position; advance: (B,) how many are valid.
    ``linear`` computes the products the cache rows depend on (the input
    fuse and the attention's projections).  Returns (logits (B,T,V),
    h (B,T,D), dcache')."""
    tok_emb = embed(embed_params, tokens, dcfg.act_dtype)
    x = _fuse_inputs(dcfg, dparams, feats, tok_emb, linear)
    x = _layer(dcfg, dparams, x, dcache["k"], dcache["v"],
               dcache["lengths"], dcache["pad"], dcache.get("tbl"), linear)
    h = rmsnorm(dparams["final_norm"], x, dcfg.norm_eps)
    logits = _head(dcfg, dparams, h)
    new_cache = dict(dcache, lengths=dcache["lengths"] + advance.to(torch.int32))
    return logits, h, new_cache


def draft_propose(dcfg: ModelConfig, dparams, embed_params, dcache, h_last,
                  first_logits, gamma: int, *, greedy: bool = True,
                  key=None, keys=None):
    """Chain-draft γ tokens.  h_last: (B, D) draft hidden at the last
    verified position; first_logits: (B, V) draft logits there.

    Greedy picks the argmax.  Sampled: with per-lane ``keys`` (B, 2),
    step j of lane b draws with ``fold_in(keys[b], j)``; with the
    batch-global ``key`` step j draws over the batch with ``split(key,
    γ)[j]``; with neither, with the zero key (as JAX's scan over zeros).

    Returns (draft_tokens (B, γ), draft_logits (B, γ, V), dcache') with
    dcache' lengths advanced by γ (the caller rolls them back)."""
    step_keys = None
    if not greedy:
        if keys is not None:
            step_keys = sample.fold_in_each(keys, gamma)       # (B, γ, 2)
        elif key is not None:
            step_keys = sample.split(key, gamma)               # (γ, 2)
        else:
            step_keys = torch.zeros((gamma, 2), dtype=torch.int64,
                                    device=first_logits.device)

    def pick(logits, j):
        if greedy:
            return logits.argmax(-1).to(torch.int32)
        if keys is not None:
            return sample.categorical_rows(step_keys[:, j], logits)
        return sample.categorical(step_keys[j], logits)

    h, logits, cache = h_last, first_logits, dcache
    toks, logitss = [], []
    for j in range(gamma):
        tok = pick(logits, j)
        tok_emb = embed(embed_params, tok[:, None], dcfg.act_dtype)
        x = _fuse_inputs(dcfg, dparams, h[:, None], tok_emb)
        x = _layer(dcfg, dparams, x, cache["k"], cache["v"],
                   cache["lengths"], cache["pad"], cache.get("tbl"))
        h_new = rmsnorm(dparams["final_norm"], x, dcfg.norm_eps)[:, 0]
        logits_new = _head(dcfg, dparams, h_new[:, None])[:, 0]
        cache = dict(cache, lengths=cache["lengths"] + 1)
        toks.append(tok)
        logitss.append(logits)
        h, logits = h_new, logits_new
    return torch.stack(toks, dim=1), torch.stack(logitss, dim=1), cache


def draft_propose_tree(dcfg: ModelConfig, dparams, embed_params, dcache,
                       h_last, first_logits, gamma: int, width: int, *,
                       greedy: bool = True, key=None, keys=None):
    """Draft a token tree: ``width`` chains of depth γ sharing the root.

    Branch 0 is the ``draft_propose`` chain verbatim, greedy or sampled
    with the same keys (width 1 is the chain).  Branch r >= 1
    re-proposes greedily from the same post-extend cache with the
    depth-1 tokens of the branches before it masked to -1e30, so sibling
    roots are distinct; its depth-1 logits row is that masked density,
    the proposal the sampled acceptance divides by.  Every branch writes
    its propose K/V at the same slots [lengths, lengths + γ), in place;
    each step reads only slots its own branch wrote, and the next
    ``draft_extend`` rewrites them all before any read.  (In JAX the
    returned cache holds branch 0's rows there; here the last branch's.)

    Returns (tokens (B, width, γ), logits (B, width, γ, V), dcache')
    with dcache' branch 0's cache (lengths advanced by γ)."""
    masked = first_logits
    toks_all, logits_all, cache0 = [], [], None
    for r in range(width):
        if r == 0:
            toks, logitss, cache0 = draft_propose(
                dcfg, dparams, embed_params, dcache, h_last, masked, gamma,
                greedy=greedy, key=key, keys=keys)
        else:
            toks, logitss, _ = draft_propose(
                dcfg, dparams, embed_params, dcache, h_last, masked, gamma)
        if r + 1 < width:
            # a scalar scatter: no host-to-device copy of the value
            masked = masked.scatter(1, toks[:, :1].long(), NEG_INF)
        toks_all.append(toks)
        logits_all.append(logitss)
    return torch.stack(toks_all, dim=1), torch.stack(logits_all, dim=1), cache0


def reset_propose(dcache, gamma: int):
    """Roll the speculative lengths back after verification."""
    return dict(dcache, lengths=dcache["lengths"] - gamma)


def seed_prompt_pairs(dcfg: ModelConfig, dparams, embed_params, dcache,
                      captures, tokens, pad):
    """The draft 'prefill': set the cache's pad and ingest the prompt
    pairs (caps[i], t_{i+1}) for i < S-1 (one ``draft_extend`` of
    T = S - 1).  The products the cache rows depend on run through
    ``linear_rows``, as the target prefill's do, so a prompt's draft rows
    do not depend on its refill batch (its row count and width): sampled
    acceptance reads the draft's probabilities, and the streams of the
    superstep and the stepwise loop, which refill in other batches, must
    agree."""
    b, s, _ = captures.shape
    dcache = dict(dcache, pad=pad.to(torch.int32, copy=True))
    _, _, dcache = draft_extend(
        dcfg, dparams, embed_params, dcache, captures[:, :s - 1],
        tokens[:, 1:],
        torch.full((b,), s - 1, dtype=torch.int32, device=captures.device),
        linear=linear_rows)
    return dcache


def seed_chunk_pairs(dcfg: ModelConfig, dparams, embed_params, dcache,
                     captures, next_tokens, advance):
    """One chunk of the draft 'prefill': ingest the pairs
    (captures[:, j], next_tokens[:, j]) for j < advance.

    A chunked refill splits ``seed_prompt_pairs`` over the prompt's
    chunks: chunk k passes its own target captures and the
    lookahead-shifted token columns (token i + 1 for capture i, sliced
    on the host from the whole prompt).  ``advance`` is the chunk's
    width for an interior chunk and one less for the last (pair S - 1
    does not exist); trailing columns are scratch that the next extend
    rewrites.  The caller sets ``dcache['pad']`` before the first chunk.
    The products the cache rows depend on run through ``linear_rows``,
    as ``seed_prompt_pairs``' do, so a chunk's draft rows do not depend
    on how many rows share its pipeline."""
    _, _, dcache = draft_extend(dcfg, dparams, embed_params, dcache,
                                captures, next_tokens, advance,
                                linear=linear_rows)
    return dcache


def seed_refill_cache(dcfg: ModelConfig, dparams, embed_params, captures,
                      tokens, pad, max_len: int):
    """A fresh draft cache for a refill batch, seeded with its prompts."""
    dcache = init_draft_cache(dcfg, captures.shape[0], max_len,
                              device=captures.device)
    return seed_prompt_pairs(dcfg, dparams, embed_params, dcache, captures,
                             tokens, pad)


def scatter_batch_rows(live, new, mask, src, axis: int = 0):
    """Overwrite, **in place**, the batch rows of ``live`` selected by
    ``mask`` (B,) with rows of ``new`` gathered at ``src`` (B,); batch at
    ``axis``.  A gather + where over the whole live tensor, as in the
    reference (fixed shapes, no host sync); ``src`` is arbitrary where
    ``mask`` is False.  Returns ``live``."""
    rows = new.index_select(axis, src.long())
    shp = [1] * rows.dim()
    shp[axis] = mask.shape[0]
    live.copy_(torch.where(mask.reshape(shp), rows.to(live.dtype), live))
    return live


def scatter_draft_rows(live, new, mask, src):
    """Replace the masked lanes of a live draft cache with lanes of a
    refill-batch cache, in place."""
    for k in live:
        scatter_batch_rows(live[k], new[k], mask, src, axis=0)
    return live


def scatter_draft_rows_paged(live, new, mask, src):
    """Paged twin of ``scatter_draft_rows``: write the K/V rows of the
    dense R-row staging cache ``new`` for the masked lanes of the paged
    ``live`` cache through its block table (other lanes go to the trash
    page), and scatter lengths/pad as rows; all in place.  The table is
    host-authoritative and left as it is."""
    from repro_torch.core.paging import write_rows_paged
    for leaf in ("k", "v"):
        rows = new[leaf].index_select(0, src.long())     # (B, W, Hk, D)
        write_rows_paged(live[leaf], live["tbl"], rows, mask)
    for leaf in ("lengths", "pad"):
        scatter_batch_rows(live[leaf], new[leaf], mask, src, axis=0)
    return live


def _ring_rows(dcfg: ModelConfig, dparams, embed_params, dcache, cap_feats,
               cap_toks, cap_count, block: int = 0):
    """The draft K/V rows of the ring-covered window under ``dparams``.

    The draft's K/V at a cache position depend only on the ingested pair
    (f, u) and the position's RoPE angle: norm1, the K/V projections and
    RoPE of the one decoder layer.  So the last ``n = min(cap_count, W)``
    positions of each lane, whose pairs the ring holds, are recomputed
    here through the decode attention's own projection and RoPE code
    (``attention.decode_qkv``), at ``start = lengths - n`` with the
    lane's pad: the positions and angles of their first ingestion.

    ``block`` > 0 computes the window ``block`` columns at a time (the
    last block padded), so that every product and norm has the shape
    serving's ``draft_extend`` gave it (``block`` = gamma + 1): a row's
    value then does not depend on how many rows its product held, and on
    the card the re-seeded rows are the serving rows bit for bit (a bf16
    product of 8·24 rows and one of 8·4 differ in the last ulps).  0
    computes the window in one pass, as JAX does.

    Returns (k, v (B, W, Hk, D), start (B,), valid (B, W)): row j of a
    lane belongs at position start + j and is valid for j < n."""
    b, w = cap_toks.shape
    dev = cap_toks.device
    n = torch.clamp(cap_count, max=w)
    j = torch.arange(w, device=dev)[None, :]
    slot = ((cap_count - n)[:, None].long() + j) % w      # ring → time order
    feats = torch.gather(cap_feats, 1, slot[..., None].expand(
        b, w, cap_feats.shape[-1]))
    toks = torch.gather(cap_toks, 1, slot)
    start = dcache["lengths"] - n
    blk = block if block > 0 else w
    wp = -(-w // blk) * blk
    if wp > w:
        feats = torch.cat([feats, feats[:, :wp - w]], dim=1)
        toks = torch.cat([toks, toks[:, :wp - w]], dim=1)
    ks, vs = [], []
    for c in range(0, wp, blk):
        x = _fuse_inputs(dcfg, dparams, feats[:, c:c + blk],
                         embed(embed_params, toks[:, c:c + blk],
                               dcfg.act_dtype))
        h = rmsnorm(dparams["norm1"], x, dcfg.norm_eps)
        _, k, v = attn.decode_qkv(dcfg, dparams["attn"], h, start + c,
                                  dcache["pad"])
        ks.append(k)
        vs.append(v)
    k, v = torch.cat(ks, dim=1)[:, :w], torch.cat(vs, dim=1)[:, :w]
    return k, v, start, j < n[:, None]


def reseed_draft_rows_from_ring(dcfg: ModelConfig, dparams, embed_params,
                                dcache, cap_feats, cap_toks, cap_count, *,
                                block: int = 0):
    """Rebuild the trailing draft-cache K/V rows under new ``dparams``
    from the rolling capture ring (deploy-time re-seed), in place.

    The last ``n = min(cap_count, W)`` positions of each lane, exactly
    the pairs the ring holds, are recomputed for the new draft
    (``_ring_rows``) and written at positions [lengths - n, lengths);
    nothing past ``lengths`` or past max_len is written.  Positions older
    than the window (and the prompt-seed region) keep the previous
    draft's K/V: token streams stay correct either way (the target
    verifies every draft); this only gives resident lanes the new
    draft's acceptance at once instead of at lane retirement.

    cap_feats: (B, W, F) ring of pair features; cap_toks: (B, W) ring of
    pair tokens; cap_count: (B,) pairs ingested since lane admission
    (the ring's write head); ``block``: see ``_ring_rows``.  Returns the
    re-seeded draft cache."""
    k, v, start, valid = _ring_rows(dcfg, dparams, embed_params, dcache,
                                    cap_feats, cap_toks, cap_count, block)
    attn.scatter_kv(dcache["k"], k, start, valid)
    attn.scatter_kv(dcache["v"], v, start, valid)
    return dcache


def reseed_draft_rows_from_ring_paged(dcfg: ModelConfig, dparams,
                                      embed_params, dcache, cap_feats,
                                      cap_toks, cap_count, max_len: int, *,
                                      block: int = 0):
    """Paged twin of ``reseed_draft_rows_from_ring``: the same rows
    (``_ring_rows``, the same inputs at the same RoPE positions, so
    paged+reseed equals dense+reseed on the gathered view bit for bit),
    written through the lane block table (``dcache["tbl"]``, which spans
    ``max_len`` positions) into the page pools in place; invalid columns
    and positions past the table go to the trash page, as every
    draft-cache write of ``core.paging`` does."""
    from repro_torch.core.paging import scatter_kv_paged
    k, v, start, valid = _ring_rows(dcfg, dparams, embed_params, dcache,
                                    cap_feats, cap_toks, cap_count, block)
    scatter_kv_paged(dcache["k"], dcache["tbl"], k, start, valid)
    scatter_kv_paged(dcache["v"], dcache["tbl"], v, start, valid)
    return dcache


# ------------------------------------------------------------- training
def _masked_ce(logits, labels, m):
    """Mean over the mask of the cross-entropy of fp32 ``logits``."""
    logz = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels[..., None])[..., 0]
    return ((logz - ll) * m).sum() / torch.clamp(m.sum(), min=1.0)


def draft_train_loss(dcfg: ModelConfig, dparams, embed_params, feats, tokens,
                     *, ttt: bool = True, mask=None):
    """EAGLE-3 training loss on captured signals (JAX
    ``core/eagle.py:491``).

    Signal convention (SignalStore / draft_extend): pair i is (f_i, u_i),
    f_i the target capture at a committed position and u_i the token
    that followed it.  Draft input at i: (f_i, e(u_i)); label u_{i+1}.
    The TTT term (weight 0.5) replays with the draft's own hidden
    ``h[:, :-1]`` as the feature, through ``_fuse_inputs``'s d-wide
    branch, and its gradient flows through ``h``.  feats: (B, S, 3D) in
    any float dtype (cast to the draft's); tokens: (B, S) ints; mask:
    optional (B, S).  The target embeddings take no gradient (they are
    read, never trained).  Returns (loss, {"accuracy": acc}), both
    0-dim fp32 tensors, the accuracy detached."""
    dt = dcfg.act_dtype
    b, s, _ = feats.shape
    tokens = tokens.long()
    labels = tokens[:, 1:]
    x = _fuse_inputs(dcfg, dparams, feats[:, :s - 1],
                     embed(embed_params, tokens[:, :s - 1], dt))
    x = _layer_full(dcfg, dparams, x)
    h = rmsnorm(dparams["final_norm"], x, dcfg.norm_eps)
    logits = _head(dcfg, dparams, h)
    m = (torch.ones(labels.shape, dtype=torch.float32, device=feats.device)
         if mask is None else mask[:, 1:].float())
    loss = _masked_ce(logits, labels, m)
    with torch.no_grad():
        acc = ((logits.argmax(-1) == labels).float() * m).sum() \
            / torch.clamp(m.sum(), min=1.0)
    if ttt and s >= 3:
        # step 2 (TTT): feature = the draft's own hidden at i, token
        # u_{i+1}, label u_{i+2}: the propose chain's input distribution
        x2 = _fuse_inputs(dcfg, dparams, h[:, :-1],
                          embed(embed_params, tokens[:, 1:s - 1], dt))
        x2 = _layer_full(dcfg, dparams, x2)
        h2 = rmsnorm(dparams["final_norm"], x2, dcfg.norm_eps)
        loss = loss + 0.5 * _masked_ce(_head(dcfg, dparams, h2),
                                       tokens[:, 2:], m[:, 1:])
    return loss, {"accuracy": acc}
