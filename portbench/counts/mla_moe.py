"""Frozen parameter and operation counts of a DeepSeek-V2 decoder
(multi-head latent attention; a dense SwiGLU in the first
``first_k_dense_replace`` layers, routed and shared SwiGLU experts after),
from its sizes (the configuration's keys as the source names them).

- A matrix product of a token costs 2 operations per weight it uses: the
  attention's projections (``wq``, ``wkv_a``, ``wkv_b``, ``wo``: in the
  absorbed form ``wkv_b`` is used once a token, folded into the query and
  the output), the dense SwiGLU or the router, the ``num_experts_per_tok``
  routed experts and the shared ones, and the output head where a token's
  logits are used.  The input embedding is a lookup.
- Absorbed attention of one query over ``keys`` latents costs ``2 * heads
  * (kv_lora_rank + qk_rope_head_dim)`` operations a key for the scores and
  ``2 * heads * kv_lora_rank`` for the weighted sum, per layer.
- These are the operations the model needs.  A layer that computes more
  (an expert block padded to its capacity) is not credited for it.
"""
from __future__ import annotations


def sizes(cfg: dict) -> dict:
    return {"d": cfg["hidden_size"], "heads": cfg["num_attention_heads"],
            "q_lora": cfg.get("q_lora_rank") or 0,
            "lora": cfg["kv_lora_rank"], "nope": cfg["qk_nope_head_dim"],
            "rope": cfg["qk_rope_head_dim"], "v": cfg["v_head_dim"],
            "ff": cfg["intermediate_size"],
            "expert_ff": cfg["moe_intermediate_size"],
            "experts": cfg["n_routed_experts"],
            "top_k": cfg["num_experts_per_tok"],
            "shared": cfg["n_shared_experts"],
            "dense_layers": cfg["first_k_dense_replace"],
            "layers": cfg["num_hidden_layers"], "vocab": cfg["vocab_size"]}


def attention_params(cfg: dict) -> int:
    """The four projections of one MLA layer (no ``q_lora``: ``wq`` whole;
    else its two factors)."""
    z = sizes(cfg)
    qk = z["nope"] + z["rope"]
    q = (z["d"] * z["heads"] * qk if not z["q_lora"] else
         z["d"] * z["q_lora"] + z["q_lora"] * z["heads"] * qk)
    return (q + z["d"] * (z["lora"] + z["rope"])
            + z["lora"] * z["heads"] * (z["nope"] + z["v"])
            + z["heads"] * z["v"] * z["d"])


def expert_params(cfg: dict) -> int:
    """One SwiGLU expert (gate, up, down)."""
    z = sizes(cfg)
    return 3 * z["d"] * z["expert_ff"]


def ffn_params(cfg: dict, layer: int) -> tuple:
    """(total, used a token) of layer ``layer``'s feed-forward: the dense
    SwiGLU, or the router, every routed expert and the shared ones (a
    token uses ``top_k`` routed experts)."""
    z = sizes(cfg)
    if layer < z["dense_layers"]:
        n = 3 * z["d"] * z["ff"]
        return n, n
    router = z["d"] * z["experts"]
    e = expert_params(cfg)
    return (router + (z["experts"] + z["shared"]) * e,
            router + (z["top_k"] + z["shared"]) * e)


def param_counts(cfg: dict) -> tuple:
    """(total, active) parameters.  Total: every weight, norms and both
    vocabulary tables included.  Active: those a token's forward
    multiplies with (every layer's attention, norms and used feed-forward,
    the final norm and the output head), the input embedding, a lookup,
    left out."""
    z = sizes(cfg)
    norms = 2 * z["d"] + z["lora"] + (z["q_lora"] or 0)
    total = active = z["d"] + z["vocab"] * z["d"]          # final norm, head
    total += z["vocab"] * z["d"]                           # embedding
    for i in range(z["layers"]):
        t, a = ffn_params(cfg, i)
        total += attention_params(cfg) + norms + t
        active += attention_params(cfg) + norms + a
    return total, active


def matmul_params(cfg: dict, logits: bool) -> int:
    """Weights one token multiplies with (no norm): every layer's
    projections and used feed-forward, and the head where its logits are
    used."""
    z = sizes(cfg)
    n = sum(attention_params(cfg) + ffn_params(cfg, i)[1]
            for i in range(z["layers"]))
    return n + (z["d"] * z["vocab"] if logits else 0)


def attention_flops(cfg: dict, keys: int) -> float:
    """One query over ``keys`` latents, absorbed, every layer."""
    z = sizes(cfg)
    per_key = 2 * z["heads"] * (2 * z["lora"] + z["rope"])
    return float(per_key * keys * z["layers"])


def forward_flops(cfg: dict, position: int, logits: bool) -> float:
    """One token's forward at ``position`` (causal: ``position + 1``
    keys)."""
    return 2.0 * matmul_params(cfg, logits) + attention_flops(cfg,
                                                             position + 1)
