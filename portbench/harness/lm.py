"""The port's language-model objects from a configuration file.

The file names its sizes as the model's ``config.json`` does; the port's
``ModelConfig`` of the same arch is taken from its registry and every size
the file states replaces the registry's, so the program runs exactly what
the file says.  Weights are drawn from the seed on the card in the stated
type (``harness/weights.py``), in the port's parameter layout.
"""
from __future__ import annotations

import dataclasses

from portbench.harness.weights import draw_tree

#: the file's keys (the model's config.json) -> the port's ModelConfig fields
FIELDS = {"hidden_size": "d_model", "intermediate_size": "d_ff",
          "num_hidden_layers": "num_layers",
          "num_attention_heads": "num_heads",
          "num_key_value_heads": "num_kv_heads", "vocab_size": "vocab_size",
          "sliding_window": "window", "rope_theta": "rope_theta",
          "norm_epsilon": "norm_eps", "dtype": "param_dtype"}


def model_config(config: dict):
    import repro_torch.configs  # noqa: F401  (registers the archs)
    from repro_torch.config import get_arch
    base = get_arch(config["arch"])
    kw = {FIELDS[k]: v for k, v in config.items() if k in FIELDS}
    kw["compute_dtype"] = config["dtype"]
    kw["head_dim"] = config["hidden_size"] // config["num_attention_heads"]
    cfg = dataclasses.replace(base, **kw)
    from portbench.harness.cell import reference
    want = reference(config["reference"]).PORT_FORM
    got = {k: getattr(cfg, k) for k in want}
    if got != want:
        raise SystemExit(f"the port's {config['arch']} is {got}; the "
                         f"reference computes {want}")
    return cfg


def weights(torch, cfg, seed: int, device):
    from repro_torch.models import transformer as T
    return draw_tree(torch, T.abstract_params(cfg), seed, device,
                     getattr(torch, cfg.param_dtype))
