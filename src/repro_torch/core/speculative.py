"""Speculative decoding, greedy chain (port of ``repro/core/speculative.py``).

Draft-propose + target-verify + exact-match acceptance, the fused
``spec_decode_step`` of the serving engine, and ``decode_superstep``: K
rounds with the Eq. 5 speculate-vs-plain gate, on-device token commit,
EOS/budget masks, the acceptance EMA and per-round signal packing.

The verify block fed to the target is ``[t0, d1, …, dγ]`` (t0 = the last
committed token); target logits at block index j give the token after
block[j]; ``n_acc`` drafts are accepted and one bonus token is taken
from logits[n_acc], so each round commits ``n_acc + 1`` tokens.

GPU execution model of this slice: PyTorch runs eagerly and cannot
branch on device values without reading them, so each superstep round
reads its two predicates (any lane active; speculate or not) with one
small device-to-host copy — K syncs per K-round superstep where the JAX
``lax.scan`` needs none.  Results do not depend on this: the same
branches run as under ``lax.cond``.  The caches are updated in place
(JAX donates them).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import eagle
from repro_torch.core.adaptive import drafter_decide
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


def _take(x, idx):
    """x[b, idx[b]] for (B, T, ...) x and (B,) idx."""
    return x[torch.arange(x.shape[0], device=x.device), idx.long()]


# ------------------------------------------------------------ verification
def verify_greedy(target_logits, draft_tokens):
    """target_logits: (B, γ+1, V); draft_tokens: (B, γ).
    Returns (n_acc (B,), bonus_token (B,)), int32.  argmax takes the
    first maximal index, as JAX's does."""
    gamma = target_logits.shape[1] - 1
    tgt = target_logits[:, :gamma].argmax(-1).to(torch.int32)
    match = (tgt == draft_tokens).to(torch.int32)
    n_acc = match.cumprod(dim=1).sum(dim=1).to(torch.int32)
    bonus = _take(target_logits, n_acc).argmax(-1).to(torch.int32)
    return n_acc, bonus


# --------------------------------------------------------------- carry
class SpecCarry(NamedTuple):
    """Pending (feature, token) pairs the draft must ingest next round:
    pair j is (feats[:, j], tokens[:, j]); the first ``advance[b]`` are
    valid."""
    feats: torch.Tensor      # (B, γ+1, 3D)
    tokens: torch.Tensor     # (B, γ+1) int32
    advance: torch.Tensor    # (B,) int32


def init_carry_from_caps(last_caps, first_token, gamma: int = 3) -> SpecCarry:
    """Carry after target prefill: one pending pair (capture of the last
    prompt position, first token)."""
    b, dev = first_token.shape[0], first_token.device
    feats = torch.zeros((b, gamma + 1, last_caps.shape[-1]),
                        dtype=last_caps.dtype, device=dev)
    feats[:, 0] = last_caps
    tokens = torch.zeros((b, gamma + 1), dtype=torch.int32, device=dev)
    tokens[:, 0] = first_token.to(torch.int32)
    return SpecCarry(feats, tokens,
                     torch.ones((b,), dtype=torch.int32, device=dev))


def init_carry(cfg: ModelConfig, dcfg: ModelConfig, prefill_out,
               first_token, gamma: int = 3) -> SpecCarry:
    return init_carry_from_caps(prefill_out["captures"][:, -1], first_token,
                                gamma)


def seed_draft_cache(cfg: ModelConfig, dcfg: ModelConfig, tparams, dparams,
                     dcache, prefill_out, prompt_tokens):
    """Draft 'prefill' through ``eagle.seed_prompt_pairs``."""
    return eagle.seed_prompt_pairs(dcfg, dparams, tparams["embed"], dcache,
                                   prefill_out["captures"], prompt_tokens,
                                   dcache["pad"])


def _require_greedy(greedy: bool):
    if not greedy:
        raise NotImplementedError("sampled decoding is not ported yet "
                                  "(ROADMAP queue 1: sampled decoding, "
                                  "verify_sample with per-lane keys)")


# ------------------------------------------------------------ fused step
def spec_decode_step(cfg: ModelConfig, dcfg: ModelConfig, tparams, dparams,
                     cache, dcache, carry: SpecCarry, *, gamma: int = 3,
                     greedy: bool = True):
    """One speculative round: draft-extend with last round's pairs,
    chain-draft γ tokens, target verify over [t0, d1..dγ], accept and
    commit.  Returns dict(tokens (B, γ+1) (scratch beyond n_commit),
    n_commit, cache, dcache, carry, captures, accept_mask, n_acc, block,
    target_logits)."""
    _require_greedy(greedy)
    ext_logits, ext_h, dcache = eagle.draft_extend(
        dcfg, dparams, tparams["embed"], dcache, carry.feats, carry.tokens,
        carry.advance)
    last = carry.advance - 1
    h_last = _take(ext_h, last)
    first_logits = _take(ext_logits, last)

    draft_tokens, _, dcache = eagle.draft_propose(
        dcfg, dparams, tparams["embed"], dcache, h_last, first_logits, gamma)

    t0 = _take(carry.tokens, last)[:, None]
    block = torch.cat([t0, draft_tokens], dim=1)
    out = T.decode_step(cfg, tparams, cache, block)
    tl = out["logits"]

    n_acc, bonus = verify_greedy(tl, draft_tokens)
    n_commit = n_acc + 1
    cache = T.commit_cache(cfg, out["cache"], n_commit)
    dcache = eagle.reset_propose(dcache, gamma)

    idx = torch.arange(gamma + 1, device=tl.device)[None, :]
    accept_mask = idx < n_commit[:, None]
    padded = torch.cat([draft_tokens, torch.zeros_like(draft_tokens[:, :1])],
                       dim=1)
    committed = torch.where(idx < n_acc[:, None], padded, bonus[:, None])
    committed = torch.where(accept_mask, committed,
                            torch.zeros_like(committed)).to(torch.int32)
    caps = out["captures"]
    carry = SpecCarry(caps, committed, n_commit)
    return {"tokens": committed, "n_commit": n_commit, "cache": cache,
            "dcache": dcache, "carry": carry, "captures": caps,
            "accept_mask": accept_mask, "n_acc": n_acc, "block": block,
            "target_logits": tl}


def plain_step_from_carry(cfg: ModelConfig, tparams, cache,
                          carry: SpecCarry, *, gamma: int = 3,
                          greedy: bool = True):
    """Plain (non-speculative) decode step driven by the spec carry: t0
    is pair ``advance-1``.  Returns the ``spec_decode_step`` layout."""
    _require_greedy(greedy)
    b, gp1 = carry.tokens.shape
    dev = carry.tokens.device
    t0 = _take(carry.tokens, carry.advance - 1)
    out = T.decode_step(cfg, tparams, cache, t0[:, None])
    nxt = out["logits"][:, 0].argmax(-1).to(torch.int32)
    ones = torch.ones((b,), dtype=torch.int32, device=dev)
    cache = T.commit_cache(cfg, out["cache"], ones)
    caps1 = out["captures"]
    feats = torch.zeros((b, gp1, caps1.shape[-1]), dtype=caps1.dtype,
                        device=dev)
    feats[:, 0] = caps1[:, 0]
    tokens = torch.zeros((b, gp1), dtype=torch.int32, device=dev)
    tokens[:, 0] = nxt
    accept_mask = torch.arange(gp1, device=dev)[None, :] < ones[:, None]
    return {"tokens": tokens, "n_commit": ones, "cache": cache,
            "carry": SpecCarry(feats, tokens, ones), "captures": feats,
            "accept_mask": accept_mask}


def ema_update(ema, ell, decay: float):
    """The acceptance EMA, one fp32 op sequence shared by both engine
    modes, so an Eq. 5 threshold compare cannot flip between them."""
    return decay * ema + (1.0 - decay) * ell


# ===================================================== fused superstep
class SuperstepState(NamedTuple):
    """Device-resident serving state threaded across supersteps."""
    carry: SpecCarry
    active: torch.Tensor      # (B,) bool
    gen_count: torch.Tensor   # (B,) int32 committed tokens (incl. first)
    accept_ema: torch.Tensor  # () f32 EMA of acceptance length E[l]
    sid: torch.Tensor         # (B,) int32 sampling-stream id per lane
    step_idx: torch.Tensor    # (B,) int32 per-lane decode-step counter


def init_superstep_state(carry: SpecCarry, first_token, *,
                         accept_ema: float = 1.0,
                         eos_id: Optional[int] = None, active0=None,
                         sids=None) -> SuperstepState:
    b, dev = first_token.shape[0], first_token.device
    active = (torch.ones((b,), dtype=torch.bool, device=dev) if active0 is None
              else torch.as_tensor(active0, dtype=torch.bool, device=dev))
    if eos_id is not None:
        active = active & (first_token != eos_id)
    sid = (torch.arange(b, dtype=torch.int32, device=dev) if sids is None
           else torch.as_tensor(sids, dtype=torch.int32, device=dev))
    return SuperstepState(
        carry=carry, active=active,
        gen_count=torch.ones((b,), dtype=torch.int32, device=dev),
        accept_ema=torch.tensor(accept_ema, dtype=torch.float32, device=dev),
        sid=sid, step_idx=torch.ones((b,), dtype=torch.int32, device=dev))


# ============================================== slot refill (continuous)
scatter_rows = eagle.scatter_batch_rows


def scatter_target_cache(cache, new, mask, src):
    """Replace, in place, the masked lanes of a live target cache with
    lanes of a freshly prefilled cache (same max_len).  ``lengths``/``pad``
    carry batch at axis 0, stacked layer leaves at axis 1."""
    for k, v in cache.items():
        if k in ("lengths", "pad"):
            scatter_rows(v, new[k], mask, src, axis=0)
        else:
            for pos, entry in v.items():
                for leaf in entry:
                    scatter_rows(entry[leaf], new[k][pos][leaf], mask, src,
                                 axis=1)
    return cache


def scatter_carry(live: SpecCarry, new: SpecCarry, mask, src) -> SpecCarry:
    """A new carry with the masked lanes replaced.  Not in place: the
    carry is small, and its tensors are also the round's committed
    tokens and captures, which the signal extractor may still read."""
    out = []
    for l, n in zip(live, new):
        rows = n.index_select(0, src.long()).to(l.dtype)
        shp = (mask.shape[0],) + (1,) * (l.dim() - 1)
        out.append(torch.where(mask.reshape(shp), rows, l))
    return SpecCarry(*out)


def refill_superstep_state(state: SuperstepState, carry_new: SpecCarry,
                           first_token, budgets, mask, src, *,
                           eos_id: Optional[int] = None,
                           sids=None) -> SuperstepState:
    """Reset the masked slots for freshly admitted requests: carry ←
    prefill carry, gen_count ← 1, active ← alive unless the first token
    is EOS or the budget is zero, step counter ← 1."""
    carry = scatter_carry(state.carry, carry_new, mask, src)
    alive = budgets >= 1
    if eos_id is not None:
        alive = alive & (first_token != eos_id)
    src_l = src.long()
    active = torch.where(mask, alive[src_l], state.active)
    gen_count = torch.where(mask, torch.ones_like(state.gen_count),
                            state.gen_count)
    step_idx = torch.where(mask, torch.ones_like(state.step_idx),
                           state.step_idx)
    sid = state.sid
    if sids is not None:
        sid = torch.where(mask, sids.to(torch.int32)[src_l], state.sid)
    return state._replace(carry=carry, active=active, gen_count=gen_count,
                          step_idx=step_idx, sid=sid)


def decode_superstep(cfg: ModelConfig, dcfg: ModelConfig, tparams, dparams,
                     cache, dcache, state: SuperstepState, max_new,
                     threshold_table=None, *, rounds: int = 8,
                     gamma: int = 3, greedy: bool = True,
                     ema_decay: float = 0.9, eos_id: Optional[int] = None,
                     collect_signals: bool = True):
    """K rounds of serving.  Each round (while any lane is active):

      1. decides speculate-vs-plain from the Eq. 5 threshold table and
         the acceptance EMA (always speculate without a table),
      2. runs ``spec_decode_step`` or ``plain_step_from_carry``,
      3. commits tokens: per-request budget clamp, optional EOS cut,
         active-mask update,
      4. packs the kept positions' training signals with the
         ``extract_pack`` kernel.

    A round with no active lane, and every round after it, is skipped
    (state and caches pass through, telemetry zero).  Returns
    dict(cache, dcache, state, rounds, host_syncs) where ``rounds`` holds
    the (K, ...)-stacked per-round telemetry."""
    from repro_torch.kernels.extract_pack.ops import pack_signals

    _require_greedy(greedy)
    gp1 = gamma + 1
    dev = state.active.device
    b = state.active.shape[0]
    f = state.carry.feats.shape[-1]
    ys_all = []
    syncs = 0
    skipping = False
    for _ in range(rounds):
        st = state
        n_active = st.active.sum().to(torch.int32)
        if threshold_table is None:
            use_spec_t = torch.ones((), dtype=torch.bool, device=dev)
        else:
            use_spec_t = drafter_decide(threshold_table, n_active,
                                        st.accept_ema)
        if not skipping:
            valid, use_spec = torch.stack(
                [st.active.any(), use_spec_t]).tolist()
            syncs += 1
            skipping = not valid
        if skipping:
            ys = {"tokens": torch.zeros((b, gp1), dtype=torch.int32, device=dev),
                  "n_commit": torch.zeros((b,), dtype=torch.int32, device=dev),
                  "n_eff": torch.zeros((b,), dtype=torch.int32, device=dev),
                  "active_after": st.active,
                  "use_spec": torch.zeros((), dtype=torch.bool, device=dev),
                  "alpha": torch.zeros((), device=dev),
                  "ell": torch.zeros((), device=dev),
                  "n_sig": torch.zeros((), dtype=torch.int32, device=dev),
                  "ema": st.accept_ema,
                  "valid": torch.zeros((), dtype=torch.bool, device=dev)}
            if collect_signals:
                ys["sig_feats"] = torch.zeros((b, gp1, f),
                                              dtype=st.carry.feats.dtype,
                                              device=dev)
                ys["sig_tokens"] = torch.zeros((b, gp1), dtype=torch.int32,
                                               device=dev)
                ys["sig_counts"] = torch.zeros((b,), dtype=torch.int32,
                                               device=dev)
            ys_all.append(ys)
            continue

        if use_spec:
            out = spec_decode_step(cfg, dcfg, tparams, dparams, cache, dcache,
                                   st.carry, gamma=gamma, greedy=greedy)
            dcache = out["dcache"]
        else:
            out = plain_step_from_carry(cfg, tparams, cache, st.carry,
                                        gamma=gamma, greedy=greedy)
        cache, carry, tokens = out["cache"], out["carry"], out["tokens"]
        n_commit, captures = out["n_commit"], out["captures"]

        act = st.active
        n_act_f = torch.clamp(n_active.float(), min=1.0)
        ncf = n_commit.float()
        zero = torch.zeros_like(ncf)
        ell = torch.where(act, ncf, zero).sum() / n_act_f
        alpha = torch.where(act, ncf - 1.0, zero).sum() / n_act_f / gamma
        ema = (ema_update(st.accept_ema, ell, ema_decay) if use_spec
               else st.accept_ema)

        remaining = torch.clamp(max_new - st.gen_count, min=0)
        n_eff = torch.where(act, torch.minimum(n_commit, remaining),
                            torch.zeros_like(n_commit))
        if eos_id is not None:
            pos = torch.arange(gp1, device=dev)[None, :]
            is_eos = (tokens == eos_id) & (pos < n_eff[:, None])
            has_eos = is_eos.any(dim=1)
            first_eos = is_eos.to(torch.int32).argmax(dim=1).to(torch.int32)
            n_eff = torch.where(has_eos, first_eos + 1, n_eff)
        else:
            has_eos = torch.zeros_like(act)
        gen_new = st.gen_count + n_eff
        active_after = act & (gen_new < max_new) & ~has_eos
        n_sig = torch.where(active_after, n_commit,
                            torch.zeros_like(n_commit)).sum()

        ys = {"tokens": tokens, "n_commit": n_commit, "n_eff": n_eff,
              "active_after": active_after,
              "use_spec": torch.tensor(use_spec, device=dev),
              "alpha": alpha, "ell": ell, "n_sig": n_sig.to(torch.int32),
              "ema": ema, "valid": torch.ones((), dtype=torch.bool, device=dev)}
        if collect_signals:
            sig_mask = torch.arange(gp1, device=dev)[None, :] < n_eff[:, None]
            ys["sig_feats"], ys["sig_tokens"], ys["sig_counts"] = \
                pack_signals(captures, tokens, sig_mask)
        ys_all.append(ys)
        state = SuperstepState(
            carry, active_after, gen_new, ema, st.sid,
            torch.where(st.active, st.step_idx + 1, st.step_idx))

    rounds_out = {k: torch.stack([ys[k] for ys in ys_all])
                  for k in ys_all[0]}
    return {"cache": cache, "dcache": dcache, "state": state,
            "rounds": rounds_out, "host_syncs": syncs}
