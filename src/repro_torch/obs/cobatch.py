"""Does a prompt's prefill depend on the prompts that share its batch?

Under greedy decoding a stream must not depend on the refill batch its
prompt was admitted in (``tests/test_policy.py``'s admission-order
property).  The refill pads every prompt to the widest of its batch
(``ServingEngine._refill_arrays``), so a co-batched prompt gets another
left pad, a wider row and a larger row count.  ``cobatch_diff`` runs the
target prefill of ``models/transformer.prefill`` op by op on two refill
batches that hold the same prompt, and compares that prompt's rows of
every op's output, bit for bit:

* ``first_departing_op``: the first op whose rows differ when both
  batches run as they are (None: the hidden states of every layer, the
  K/V rows and the last-position logits are equal).
* ``departing_alone``: every op whose rows differ although its inputs'
  rows were made equal (the second batch's inputs get the first batch's
  rows of the prompt before each op): the ops that depend on the batch
  themselves, and not only through their inputs.

The op sequence mirrors ``transformer.prefill`` with a dense cache (the
layer's K/V rows are the ``k_rope`` and ``v_proj`` outputs; an MLA
layer's latent rows the ``kv_norm`` and ``k_rope`` outputs), and the
function checks that its logits equal ``transformer.prefill``'s.  A MoE
layer's FFN is one op (``moe``): its expert capacity comes from the
batch's token count (JAX's ``_capacity``), so it can depart alone.  An
MLA layer (``models/mla.py``, the expanded prefill) is its products
(``q_a``, ``q_b``, ``kv_a``, ``kv_b``, ``o_proj``), its norms, RoPE and
concatenations, and the prefill kernel at (192, 128) with
``pad_rows_mean_v`` (``attention``); the groups are named as in the
params (``pre.0.``, ``body.0.``).

    diff = cobatch_diff(cfg, params, (toks_a, pad_a, row_a),
                        (toks_b, pad_b, row_b))

The same property at the kernel level: ``placed_rows`` puts one lane's
q/k/v at a given pad of a batch row, a given width past it, beside lanes
of other contents, and returns that lane's rows of one attention kernel
(prefill or verify, dense or paged, chain or tree, or the MLA latent
decode, ``mla_lane_inputs``); they must be equal, bit for bit, for every
placement (``pad_shift_departure``).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels.flash_attn.ops import (flash_attention,
                                                flash_attention_paged)
from repro_torch.kernels.linear_rows.ops import linear_rows
from repro_torch.kernels.mla_attn.ops import mla_attention
from repro_torch.kernels.verify_attn.ops import (verify_attention,
                                                 verify_attention_paged)
from repro_torch.models import moe
from repro_torch.models import transformer as T
from repro_torch.models.attention import (_proj, apply_rope, out_proj,
                                          pad_rows_mean_v)
from repro_torch.models.config import FFN_GELU, FFN_MOE, MLA
from repro_torch.models.layers import embed, lm_head, rmsnorm

# (name, fn, input keys, output key); fn takes the inputs in that order
Step = Tuple[str, Callable, Sequence[str], str]


def _ffn_steps(cfg, blk, p, tag: str, linear) -> List[Step]:
    """The layer's FFN on "h" as steps, its output "a"."""
    if blk.ffn == FFN_MOE:
        return [(tag + "moe", lambda h: moe.moe_sort(cfg, p["moe"], h,
                                                     linear)[0],
                 ["h"], "a")]
    f = p["ffn"]
    if blk.ffn == FFN_GELU:
        return [
            (tag + "ffn_up", lambda h: linear(h, f["w_up"])
             + f["b_up"].to(h.dtype), ["h"], "u"),
            (tag + "ffn_act", lambda u: torch.nn.functional.gelu(
                u, approximate="tanh"), ["u"], "g"),
            (tag + "ffn_down", lambda g: linear(g, f["w_down"])
             + f["b_down"].to(g.dtype), ["g"], "a")]
    return [
        (tag + "ffn_gate", lambda h: linear(h, f["w_gate"]), ["h"], "g"),
        (tag + "ffn_up", lambda h: linear(h, f["w_up"]), ["h"], "u"),
        (tag + "ffn_act", lambda g, u: torch.nn.functional.silu(g) * u,
         ["g", "u"], "g"),
        (tag + "ffn_down", lambda g: linear(g, f["w_down"]), ["g"], "a")]


def _attn_steps(cfg, mix, tag: str, pad, positions, linear) -> List[Step]:
    """An attention layer's mixer on "h" as steps, its output "a"."""
    theta = cfg.rope_theta
    return [
        (tag + "q_proj", lambda h: _proj(h, mix["wq"], linear), ["h"], "q"),
        (tag + "k_proj", lambda h: _proj(h, mix["wk"], linear), ["h"], "k"),
        (tag + "v_proj", lambda h: _proj(h, mix["wv"], linear), ["h"], "v"),
        (tag + "q_rope", lambda q: apply_rope(q, positions, theta), ["q"],
         "q"),
        (tag + "k_rope", lambda k: apply_rope(k, positions, theta), ["k"],
         "k"),
        (tag + "attention", lambda q, k, v: pad_rows_mean_v(
            flash_attention(q, k, v, pad, causal=True, window=cfg.window,
                            softcap=cfg.attn_logit_softcap), v, pad),
         ["q", "k", "v"], "o"),
        (tag + "o_proj", lambda o: out_proj(mix, o, linear), ["o"], "a"),
    ]


def _mla_steps(cfg, mix, tag: str, pad, positions, linear) -> List[Step]:
    """An MLA layer's mixer on "h" as steps (``mla.mla_prefill``), its
    output "a"."""
    eps, theta = cfg.norm_eps, cfg.rope_theta
    r, dn, dr = cfg.kv_lora_rank, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim

    def k_cat(kvb, kr):
        b, s, h, _ = kvb.shape
        return torch.cat([kvb[..., :dn], kr[:, :, None].expand(b, s, h, dr)],
                         dim=-1)

    return [
        (tag + "q_a", lambda h: linear(h, mix["wq_a"]), ["h"], "qa"),
        (tag + "q_norm", lambda qa: rmsnorm({"scale": mix["q_norm"]}, qa,
                                            eps), ["qa"], "qa"),
        (tag + "q_b", lambda qa: _proj(qa, mix["wq_b"], linear), ["qa"],
         "q"),
        (tag + "q_rope", lambda q: torch.cat(
            [q[..., :dn], apply_rope(q[..., dn:], positions, theta)], -1),
         ["q"], "q"),
        (tag + "kv_a", lambda h: linear(h, mix["wkv_a"]), ["h"], "kva"),
        (tag + "kv_norm", lambda kva: rmsnorm({"scale": mix["kv_norm"]},
                                              kva[..., :r], eps),
         ["kva"], "ckv"),
        (tag + "k_rope", lambda kva: apply_rope(kva[..., None, r:],
                                                positions, theta)[:, :, 0],
         ["kva"], "kr"),
        (tag + "kv_b", lambda ckv: _proj(ckv, mix["wkv_b"], linear),
         ["ckv"], "kvb"),
        (tag + "k_cat", k_cat, ["kvb", "kr"], "k"),
        (tag + "v_split", lambda kvb: kvb[..., dn:].contiguous(), ["kvb"],
         "v"),
        (tag + "attention", lambda q, k, v: pad_rows_mean_v(
            flash_attention(q, k, v, pad, causal=True), v, pad),
         ["q", "k", "v"], "o"),
        (tag + "o_proj", lambda o: out_proj(mix, o, linear), ["o"], "a"),
    ]


def prefill_steps(cfg, params, pad, positions,
                  linear=linear_rows) -> List[Step]:
    """The dense target prefill of ``transformer.prefill`` as steps over
    a state dict that starts as {"tokens": (B, S) int}.  Every output
    but the last ("logits", (B, V) at the last position) is (B, S, ...).
    ``linear``: the matrix product of the projections, the FFN, the
    router and the LM head (``transformer.prefill``'s is
    ``linear_rows``)."""
    eps = cfg.norm_eps
    steps: List[Step] = [("embed", lambda t: embed(params["embed"], t,
                                                   cfg.act_dtype),
                          ["tokens"], "x")]
    for name, pattern, repeats in T.model_groups(cfg):
        per_pos = [T._slices(params[name], repeats, pi)
                   for pi in range(len(pattern))]
        for i in range(repeats):
            for pi, blk in enumerate(pattern):
                p = per_pos[pi][i]
                mix = p["mix"]
                tag = f"{name}.{i * len(pattern) + pi}."
                norm1 = (tag + "norm1",
                         lambda x, p=p: rmsnorm(p["norm1"], x, eps),
                         ["x"], "h")
                mixer = _mla_steps if blk.mixer == MLA else _attn_steps
                steps += [norm1] + mixer(cfg, mix, tag, pad, positions,
                                         linear)
                steps += [
                    (tag + "residual1", lambda x, a: x + a, ["x", "a"], "x"),
                    (tag + "norm2", lambda x, p=p: rmsnorm(p["norm2"], x, eps),
                     ["x"], "h"),
                ]
                steps += _ffn_steps(cfg, blk, p, tag, linear)
                steps.append((tag + "residual2", lambda x, a: x + a,
                              ["x", "a"], "x"))
    steps += [
        ("final_norm", lambda x: rmsnorm(params["final_norm"], x,
                                         cfg.norm_eps), ["x"], "x"),
        ("logits", lambda x: lm_head(params.get("head"), params["embed"],
                                     x[:, -1], cfg.tie_embeddings,
                                     linear=linear).float(),
         ["x"], "logits"),
    ]
    return steps


def _rows(t: torch.Tensor, row: int, pad: int) -> torch.Tensor:
    """The prompt's rows of one op's tensor: positions [pad, S) of its
    batch row (the whole row of the last-position logits)."""
    return t[row] if t.dim() == 2 and t.is_floating_point() else t[row, pad:]


def _run(cfg, params, toks, pad, row, force: Optional[Dict] = None,
         linear=linear_rows):
    """Run the steps; returns ({op: the prompt's output rows}, {op: its
    input rows}, logits).  With ``force`` (another run's input rows),
    each op's inputs get those rows of the prompt first."""
    s = toks.shape[1]
    p0 = int(pad[row])
    positions = torch.clamp(torch.arange(s, device=toks.device)[None, :]
                            - pad[:, None].long(), min=0)
    state = {"tokens": toks}
    outs, ins = {}, {}
    for name, fn, keys, key in prefill_steps(cfg, params, pad, positions,
                                             linear):
        args = [state[k] for k in keys]
        if force is not None:
            args = [a.clone() for a in args]
            for a, rows in zip(args, force[name]):
                a[row, p0:] = rows
        ins[name] = [_rows(a, row, p0).clone() for a in args]
        state[key] = fn(*args)
        outs[name] = _rows(state[key], row, p0).clone()
    return outs, ins, state["logits"]


def cobatch_diff(cfg, params, a, b, linear=linear_rows) -> Dict:
    """``a``, ``b``: (tokens (R, S) int32, pad (R,) int32, row) of two
    refill batches on one device whose given rows hold the same prompt,
    right-aligned (S - pad[row] equal).  ``linear``: the matrix product
    of the steps; another than ``transformer.prefill``'s (``linear_rows``,
    e.g. ``torch.matmul`` to read the library's) skips the check that
    the steps compute ``transformer.prefill``.  Returns a dict: the prompt
    length, both batches' shapes and pads, ``first_departing_op`` (or
    None) with the largest difference of its rows, ``departing_alone``
    (list), whether the K/V rows of every layer, the hidden states of
    every layer and the logits are equal, the logits' largest difference,
    and whether their argmax (the greedy token) is equal."""
    (ta, pa, ra), (tb, pb, rb) = a, b
    la, lb = ta.shape[1] - int(pa[ra]), tb.shape[1] - int(pb[rb])
    if la != lb or not torch.equal(ta[ra, int(pa[ra]):], tb[rb, int(pb[rb]):]):
        raise ValueError("the two rows do not hold the same prompt")
    with torch.no_grad():
        out_a, in_a, logits_a = _run(cfg, params, ta, pa, ra, linear=linear)
        if linear is linear_rows:
            ref = T.prefill(cfg, params, ta, pad=pa)["logits"]
            if not torch.equal(ref, logits_a):
                raise RuntimeError("prefill_steps no longer computes "
                                   "transformer.prefill")
        out_b, _, _ = _run(cfg, params, tb, pb, rb, linear=linear)
        forced, _, _ = _run(cfg, params, tb, pb, rb, force=in_a,
                            linear=linear)
    names = list(out_a)
    same = {n: torch.equal(out_a[n], out_b[n]) for n in names}
    first = next((n for n in names if not same[n]), None)

    def all_equal(suffix):
        return all(same[n] for n in names if n.endswith(suffix))

    def max_diff(n):
        return float((out_a[n].float() - out_b[n].float()).abs().max())

    return {"prompt_len": la,
            "batch_a": list(ta.shape), "pad_a": int(pa[ra]),
            "batch_b": list(tb.shape), "pad_b": int(pb[rb]),
            "first_departing_op": first,
            "first_max_abs_diff": None if first is None else max_diff(first),
            "logits_max_abs_diff": max_diff("logits"),
            "argmax_equal": bool(out_a["logits"].argmax()
                                 == out_b["logits"].argmax()),
            "departing_alone": [n for n in names
                                if not torch.equal(out_a[n], forced[n])],
            "kv_rows_equal": all(all_equal(k) for k in (
                ".k_rope", ".v_proj", ".kv_norm")),
            "hidden_equal": all_equal(".residual2"),
            "logits_equal": same["logits"]}


# ------------------------------------------------- kernel-level placement
SHIFT_PADS = (0, 5, 17, 31, 32, 100)
SHIFT_EXTRA = (0, 40, 100)
SHIFT_KINDS = ("prefill", "prefill_paged", "verify4", "verify1",
               "verify_paged4", "verify_paged1", "tree", "tree_paged")
SHIFT_PAGE = 16


def _randn(shape, dtype, device, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randn(shape, generator=g).to(device=device, dtype=dtype)


def lane_inputs(length, hq, hk, d, dtype, device, seed):
    """One lane's q (length, Hq, D), k and v (length, Hk, D)."""
    return (_randn((length, hq, d), dtype, device, seed),
            _randn((length, hk, d), dtype, device, seed + 1),
            _randn((length, hk, d), dtype, device, seed + 2))


def mla_lane_inputs(length, heads, dtype, device, seed, r=512, dr=64):
    """One lane's MLA decode inputs: q_lat (length, H, R), q_rope
    (length, H, Dr), ckv (length, R), kr (length, Dr)."""
    return (_randn((length, heads, r), dtype, device, seed),
            _randn((length, heads, dr), dtype, device, seed + 1),
            _randn((length, r), dtype, device, seed + 2),
            _randn((length, dr), dtype, device, seed + 3))


# the MLA decode's scale at DeepSeek-V3's widths, 1/sqrt(128 + 64)
MLA_SHIFT_SCALE = 192 ** -0.5


def _placed(x, p, width, seed):
    """(3, width, ...) random rows; row 1 holds ``x`` at [p, p + len)."""
    out = _randn((3, width) + tuple(x.shape[1:]), x.dtype, x.device, seed)
    out[1, p:p + x.shape[0]] = x
    return out


def _pooled(k, v, seed):
    """Page pools (SHIFT_PAGE) holding dense (B, S, Hk, D) k/v through
    shuffled tables (S a multiple of the page), the trash page last."""
    b, s = k.shape[:2]
    n_tbl = s // SHIFT_PAGE
    g = torch.Generator(device="cpu").manual_seed(seed)
    tbl = torch.randperm(b * n_tbl, generator=g).to(torch.int32).reshape(
        b, n_tbl).to(k.device)
    pools = []
    for x in (k, v):
        pool = torch.zeros((b * n_tbl + 1, SHIFT_PAGE) + tuple(x.shape[2:]),
                           dtype=x.dtype, device=x.device)
        pool[tbl.long()] = x.reshape(b, n_tbl, SHIFT_PAGE, *x.shape[2:])
        pools.append(pool)
    return pools[0], pools[1], tbl


def placed_rows(kind, lane, p, extra, seed):
    """Lane 1's rows of one kernel call with the lane's prompt at pad
    ``p`` and the batch ``extra`` positions wider than pad + prompt.
    ``lane``: ``lane_inputs(L, ...)`` (``mla_lane_inputs`` for the MLA
    kinds "mla1", "mla4", "mla128", decode kinds as the verify's).  Prefill kinds: the prompt's L
    rows.  Decode kinds (verify T = 4 or 1, "verify128" a chunked
    refill's continuation, tree W 4 gamma 3 with T = 13; L >= T): the
    cache holds the L keys at [p, p + L), the last T of them
    the block's, and the lane's rows are the T query rows.  The other
    lanes' contents, pads and lengths change with ``seed``."""
    if kind.startswith("mla"):
        return _placed_mla(kind, lane, p, extra, seed)
    q, k, v = lane
    length = k.shape[0]
    if kind.startswith("prefill"):
        s = p + length + extra
        qb, kb, vb = (_placed(x, p, s, seed + i) for i, x in enumerate(lane))
        pad = torch.tensor([(7 * seed) % s, p, s // 3], dtype=torch.int32,
                           device=q.device)
        if kind == "prefill":
            return flash_attention(qb, kb, vb, pad)[1, p:p + length]
        s_pg = -(-s // SHIFT_PAGE) * SHIFT_PAGE
        kp, vp, tbl = _pooled(torch.cat([kb, kb[:, :s_pg - s]], 1),
                              torch.cat([vb, vb[:, :s_pg - s]], 1), seed)
        return flash_attention_paged(qb, kp, vp, tbl, pad)[1, p:p + length]
    tree = (4, 3) if kind.startswith("tree") else None
    t = 13 if tree else int("".join(c for c in kind if c.isdigit()))
    smax = -(-(p + length + extra) // SHIFT_PAGE) * SHIFT_PAGE
    kb, vb = _placed(k, p, smax, seed + 1), _placed(v, p, smax, seed + 2)
    qb = _placed(q[:t], 0, t, seed)
    lengths = torch.tensor([smax // 2, p + length - t, smax - t],
                           dtype=torch.int32, device=q.device)
    pad = torch.tensor([seed % 7, p, 3], dtype=torch.int32, device=q.device)
    kw = {} if tree is None else {"tree": tree}
    if "paged" in kind:
        kp, vp, tbl = _pooled(kb, vb, seed)
        return verify_attention_paged(qb, kp, vp, tbl, lengths, pad, **kw)[1]
    return verify_attention(qb, kb, vb, lengths, pad, **kw)[1]


def _placed_mla(kind, lane, p, extra, seed):
    ql, qr, ckv, kr = lane
    t, length = int(kind[3:]), ckv.shape[0]
    smax = -(-(p + length + extra) // SHIFT_PAGE) * SHIFT_PAGE
    cb, kb = _placed(ckv, p, smax, seed + 1), _placed(kr, p, smax, seed + 2)
    qlb, qrb = _placed(ql[:t], 0, t, seed), _placed(qr[:t], 0, t, seed + 3)
    lengths = torch.tensor([smax // 2, p + length - t, smax - t],
                           dtype=torch.int32, device=ql.device)
    pad = torch.tensor([seed % 7, p, 3], dtype=torch.int32, device=ql.device)
    return mla_attention(qlb, qrb, cb, kb, lengths, pad,
                         scale=MLA_SHIFT_SCALE)[1]


def pad_shift_departure(kind, lane, extras=SHIFT_EXTRA):
    """The first placement (pad, extra) of ``lane`` over SHIFT_PADS x
    ``extras`` whose rows of kernel ``kind`` are not finite or differ
    from the first placement's, or None: the lane's attention does not
    depend on where its prompt sits in the batch."""
    ref, seed = None, 90
    for p in SHIFT_PADS:
        for extra in extras:
            seed += 3
            got = placed_rows(kind, lane, p, extra, seed)
            if ref is None:
                ref = got
            if not (torch.isfinite(got).all() and torch.equal(got, ref)):
                return p, extra
    return None
