"""Plain PyTorch versions of the sampling kernels (``csrc/
threefry_sample.cu``), built on ``core/prng.py``.  The reference has no
kernel here: it samples with ``jax.random`` in jnp code."""
from __future__ import annotations

import torch

from repro_torch.core import prng


def threefry2x32_ref(keys, counters):
    """keys (R, 2), counters (R, N, 2) int64 uint32 words → (R, N, 2)."""
    return prng.hash_pairs(keys, counters)


def perturbed_rows_ref(keys, logits, row_stride: int = 0):
    """``logits + gumbel``: the values whose argmax is the draw of
    ``categorical_rows_ref`` (R, V) fp32."""
    r, v = logits.shape
    bits = prng.hash_pairs(keys, prng.row_counters(r, v, row_stride,
                                                   logits.device))
    return logits + prng.gumbel_from_bits(bits[..., 0] ^ bits[..., 1])


def categorical_rows_ref(keys, logits, row_stride: int = 0):
    """``jax.random.categorical`` of each row of logits (R, V) fp32 under
    its own key (R, 2), the noise of row r at flat indices r·row_stride +
    [0, V).  Returns (R,) int32."""
    return perturbed_rows_ref(keys, logits, row_stride).argmax(-1).to(
        torch.int32)


def near_tie_rows(z):
    """(R,) bool: rows of z (R, V) whose top two values lie within
    4·eps32·max|z|, where a kernel's draw may differ from the plain
    version's (the two may round a logf or a sum differently)."""
    if z.shape[-1] < 2:
        return torch.zeros(z.shape[:-1], dtype=torch.bool, device=z.device)
    top = z.float().topk(2, dim=-1).values
    eps = torch.finfo(torch.float32).eps
    return (top[:, 0] - top[:, 1]) <= 4 * eps * z.float().abs().amax(-1)


def tree_first_token_law(target_logits, draft_logits, width: int,
                         min_mass: float = 1e-12):
    """The exact law of the first token ``verify_tree_sample`` commits
    over the engine's draft tree (``eagle.draft_propose_tree``), for one
    lane whose every node sees the same logits: branch 0's root y drawn
    from softmax(draft_logits), sibling r's root the argmax of the draft
    logits with the earlier roots masked, each root tested at depth 1
    against the running residual as ``verify_tree_sample`` tests it, and
    the bonus drawn from the residual once every root is rejected.  Width
    1 is Leviathan's rule, whose law is softmax(target_logits).  Roots y
    of draft mass below ``min_mass`` are left out (their total mass is
    the law's error).  target_logits, draft_logits: (V,).  Returns (V,)
    float64."""
    p = torch.softmax(target_logits.double(), dim=-1)
    d = draft_logits.double()
    q0 = torch.softmax(d, dim=-1)
    law = torch.zeros_like(p)
    for y in torch.nonzero(q0 >= min_mass).flatten().tolist():
        acc = min(1.0, float(p[y] / torch.clamp(q0[y], min=1e-20)))
        law[y] += q0[y] * acc
        rest = q0[y] * (1.0 - acc)
        p_cur = torch.clamp(p - q0, min=0.0)
        masked = d.clone()
        masked[y] = -1e30
        for _ in range(1, width):
            s = int(masked.argmax())
            q_r = torch.softmax(masked, dim=-1)
            p_test = p_cur / torch.clamp(p_cur.sum(), min=1e-20)
            acc = min(1.0, float(p_test[s] / torch.clamp(q_r[s], min=1e-20)))
            law[s] += rest * acc
            rest = rest * (1.0 - acc)
            p_cur = torch.clamp(p_cur - q_r, min=0.0)
            masked[s] = -1e30
        law += rest * p_cur / torch.clamp(p_cur.sum(), min=1e-20)
    return law
