"""Frozen operation and byte counts of a dense decoder (GQA attention, a
two-matrix MLP), from its sizes (the configuration's keys as the source
names them).

- A matrix product of a token costs 2 operations per weight.
- Attention of one query over ``keys`` keys costs ``4 * heads * head_dim *
  keys`` operations (scores and the weighted sum) per layer.
- The least bytes attention needs: each live key and value read once in
  the cache's type, with its 4-byte position, the query read and the
  output written once.
"""
from __future__ import annotations


def sizes(cfg: dict) -> dict:
    d = cfg["hidden_size"]
    h = cfg["num_attention_heads"]
    return {"d": d, "heads": h, "kv_heads": cfg["num_key_value_heads"],
            "head_dim": d // h, "ff": cfg["intermediate_size"],
            "layers": cfg["num_hidden_layers"], "vocab": cfg["vocab_size"],
            "window": cfg.get("sliding_window") or 0, "item": 2}


def layer_matmul_params(cfg: dict) -> int:
    z = sizes(cfg)
    q, kv = z["heads"] * z["head_dim"], z["kv_heads"] * z["head_dim"]
    return z["d"] * (q + 2 * kv) + q * z["d"] + 2 * z["d"] * z["ff"]


def unembed_params(cfg: dict) -> int:
    z = sizes(cfg)
    return z["d"] * z["vocab"]


def keys_seen(cfg: dict, position: int) -> int:
    """Keys a query at ``position`` attends (causal, in the window)."""
    w = sizes(cfg)["window"]
    return min(position + 1, w) if w else position + 1


def attention_flops(cfg: dict, keys: int) -> float:
    """One query over ``keys`` keys, every layer."""
    z = sizes(cfg)
    return 4.0 * z["heads"] * z["head_dim"] * keys * z["layers"]


def decode_attention_bytes(cfg: dict, keys: int) -> float:
    z = sizes(cfg)
    kv = keys * (z["kv_heads"] * z["head_dim"] * 2 * z["item"] + 4)
    q = 2 * z["heads"] * z["head_dim"] * z["item"]
    return float(kv + q) * z["layers"]


def prefill_attention(cfg: dict, prompt: int) -> tuple:
    """(operations, bytes) of causal attention over a whole prompt, every
    layer: each query over the keys at or before it, each key and value
    read once."""
    z = sizes(cfg)
    flops = sum(attention_flops(cfg, keys_seen(cfg, p))
                for p in range(prompt))
    kv = prompt * (z["kv_heads"] * z["head_dim"] * 2 * z["item"] + 4)
    q = 2 * prompt * z["heads"] * z["head_dim"] * z["item"]
    return flops, float(kv + q) * z["layers"]


def forward_flops(cfg: dict, position: int, logits: bool) -> float:
    """One token's forward at ``position``: every layer's products, its
    attention, and the vocabulary projection where its logits are used."""
    z = sizes(cfg)
    return (2.0 * layer_matmul_params(cfg) * z["layers"]
            + attention_flops(cfg, keys_seen(cfg, position))
            + (2.0 * unembed_params(cfg) if logits else 0.0))


def train_step_flops(cfg: dict, batch: int, seq: int) -> float:
    """Forward and backward (3x the forward) of ``batch`` sequences of
    ``seq`` tokens, logits at every position."""
    per_seq = sum(forward_flops(cfg, p, True) for p in range(seq))
    return 3.0 * batch * per_seq
