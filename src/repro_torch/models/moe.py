"""Mixture-of-Experts layer: top-k routing, capacity, shared experts.

Counterpart of the reference's ``models/moe.py`` (its EP sharding is not
ported: the port runs on one card).  Sort-based dispatch with static
shapes: each token is copied K times, the copies are sorted by expert id
(a stable sort, so within one expert they keep token order), ranked within
their expert, and gathered into a dense ``(E, C, D)`` block which runs
through the stacked expert weights.  Copies past an expert's capacity
``C`` are dropped (their combine weight never fires), GShard-style.  The
router aux (load-balance) loss follows Switch/DeepSeek:
``aux = E * sum_e f_e * P_e * router_aux_coef``.

Where the port has to choose what the reference leaves to its framework:

  * Top-k: ``jax.lax.top_k`` breaks ties toward the lower expert index;
    ``torch.topk`` promises no order.  The port takes the first K of a
    stable descending sort, which keeps the lower index first among equal
    probabilities (an all-zero row ties across every expert).
  * Capacity is per call: ``C = max(int(K * N * capacity_factor / E), 4)``
    with N = B * S, every row the call carries (padding and inactive
    decode slots included).  Two callers that batch rows differently drop
    different copies.  A config with ``capacity_factor=None`` (the port's
    own field) serves dropless: ``C = N``, the most copies one expert can
    receive (a token routes to K distinct experts), so no copy drops and
    a token's output does not depend on the rows beside it; the shapes
    stay static, at E / K times the rows routed.  Where a capacity
    applies, a serving engine counts the dropped copies on the device
    (``models/observe.py``).
  * Gates: the top-k probabilities renormalised to sum to 1, as the
    reference does; ``norm_topk_prob=False`` (the port's own field, as
    DeepSeek-V2-Lite publishes it) keeps them raw.
  * Combine: the reference scatter-adds every expert slot into its token
    (``.at[].add``); ``index_add_`` on CUDA uses atomics, whose order
    varies between runs.  The port instead gathers each token's K weighted
    copies and sums them in one fixed order: ascending slot, i.e. ascending
    expert id (the order the reference's scatter walks its slots), starting
    from 0, in fp32; a dropped copy adds the zero scratch row.  The result
    is deterministic on the card and the CPU.  It is not bitwise the
    reference's (the expert products are matrix multiplies of another
    library); module-level fp32 parity holds at 2e-5.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models import observe
from repro_torch.models.layers import apply_mlp, gelu, mlp_params
from repro_torch.models.param import P
from repro_torch.sharding.gathered import replicate, replicated_local


def moe_params(cfg: ModelConfig) -> dict:
    m = cfg.moe
    d = cfg.d_model
    ff = m.expert_ff
    glu = cfg.mlp in ("swiglu", "geglu")
    p = {
        "router": P((d, m.num_experts), ("embed", "expert")),
        "wi": P((m.num_experts, d, ff), ("expert", "embed", "expert_mlp")),
        "wo": P((m.num_experts, ff, d), ("expert", "expert_mlp", "embed")),
    }
    if glu:
        p["wg"] = P((m.num_experts, d, ff), ("expert", "embed", "expert_mlp"))
    if m.num_shared_experts:
        # shared experts fused into one dense MLP of width n_shared * ff
        p["shared"] = mlp_params(cfg, d_ff=m.num_shared_experts * ff)
    return p


def _expert_ffn(cfg: ModelConfig, p: dict, xs: torch.Tensor) -> torch.Tensor:
    """xs: (E, C, D) -> (E, C, D) via per-expert (gated) MLP, batched
    matrix products in ``xs``'s dtype."""
    dt = xs.dtype
    h = torch.bmm(xs, p["wi"].to(dt))
    if "wg" in p:
        g = torch.bmm(xs, p["wg"].to(dt))
        act = F.silu(g) if cfg.mlp == "swiglu" else gelu(g)
        h = act * h
    else:
        h = gelu(h)
    return torch.bmm(h, p["wo"].to(dt))


def _top_k(probs: torch.Tensor, k: int):
    """The K largest per row, lower index first among ties (``lax.top_k``'s
    order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def expert_capacity(cfg: ModelConfig, rows: int) -> int:
    """C, the slots of each expert in a call over ``rows`` tokens: GShard's
    ``max(int(K * N * capacity_factor / E), 4)``, or N where the config
    serves dropless (``capacity_factor=None``)."""
    m = cfg.moe
    if m.capacity_factor is None:
        return rows
    return max(int(m.top_k * rows * m.capacity_factor / m.num_experts), 4)


def dispatch_sizes(cfg: ModelConfig, rows: int) -> tuple:
    """(routed copies N * K, expert rows computed E * C) of one MoE layer
    over ``rows`` tokens: known from shapes, with no look at the card."""
    m = cfg.moe
    return rows * m.top_k, m.num_experts * expert_capacity(cfg, rows)


def moe_apply(cfg: ModelConfig, p: dict, x: torch.Tensor):
    """x: (B, S, D).  Returns (y, aux_loss)."""
    m = cfg.moe
    # over DTensors the layer runs on every token (rows gathered): the
    # experts stay split over their axis, and the routing's scatters never
    # meet a row split (sharding.gathered)
    x = replicate(x)
    B, S, D = x.shape
    E, K = m.num_experts, m.top_k
    N = B * S
    dev = x.device
    x2 = x.reshape(N, D)

    # --- routing (fp32 for numerics) ---
    logits = x2.float() @ p["router"].float()                        # (N,E)
    probs = torch.softmax(logits, dim=-1)
    # the routing's index bookkeeping runs on the whole of probs on every
    # rank (sharding.gathered); on plain tensors this is the identity
    probs, as_dtensor = replicated_local(probs)
    gate, eid = _top_k(probs, K)                                     # (N,K)
    if m.norm_topk_prob:
        gate = gate / gate.sum(dim=-1, keepdim=True)                 # renorm

    # aux load-balance loss: E * sum_e f_e * P_e
    f = F.one_hot(eid, E).float().sum(dim=1).mean(dim=0)
    pbar = probs.mean(dim=0)
    aux = E * (f * pbar).sum() * m.router_aux_coef

    # --- dispatch: sort token copies by expert ---
    C = expert_capacity(cfg, N)
    eid_flat = eid.reshape(-1)                                       # (N*K,)
    tok_of_copy = torch.arange(N * K, device=dev) // K
    order = torch.argsort(eid_flat, stable=True)
    sorted_eid = eid_flat[order]
    counts = torch.zeros(E, dtype=torch.long, device=dev).index_add_(
        0, eid_flat, torch.ones_like(eid_flat))                      # (E,)
    seg_start = torch.cumsum(counts, 0) - counts
    rank = torch.arange(N * K, device=dev) - seg_start[sorted_eid]
    valid = rank < C
    if C < N:
        observe.count_dropped((~valid).sum())
    dest = torch.where(valid, sorted_eid * C + rank,
                       torch.full_like(rank, E * C))     # drop -> scratch

    # slot -> token (N: the zero pad row) and gate; kept copies land in
    # their slot, dropped ones in the scratch slot E*C, cut off after
    slot_tok = torch.full((E * C + 1,), N, dtype=torch.long, device=dev)
    slot_gate = torch.zeros((E * C + 1,), dtype=torch.float32, device=dev)
    slot_tok[dest] = tok_of_copy[order]
    slot_gate[dest] = gate.reshape(-1)[order]
    slot_tok, slot_gate = slot_tok[:E * C], slot_gate[:E * C]
    copy_slot = torch.empty_like(dest)
    copy_slot[order] = dest                     # copy (n, k) -> its slot
    copy_slot = torch.sort(copy_slot.reshape(N, K), dim=1).values
    slot_tok, slot_gate, copy_slot, aux = (
        as_dtensor(t) for t in (slot_tok, slot_gate, copy_slot, aux))

    x_pad = torch.cat([x2, x2.new_zeros((1, D))], dim=0)
    xs = x_pad[slot_tok].reshape(E, C, D)                            # (E,C,D)
    ys = _expert_ffn(cfg, p, xs).reshape(E * C, D)

    # --- combine: each token's K copies, ascending slot, in fp32 ---
    weighted = torch.cat([ys.float() * slot_gate[:, None],
                          ys.new_zeros((1, D), dtype=torch.float32)], dim=0)
    y = torch.zeros((N, D), dtype=torch.float32, device=dev)
    for j in range(K):
        y = y + weighted[copy_slot[:, j]]
    y = y.to(x.dtype).reshape(B, S, D)

    if m.num_shared_experts:
        y = y + apply_mlp(cfg, p["shared"], x)
    return replicate(y), aux
