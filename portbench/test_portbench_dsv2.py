"""The DeepSeek-V2-Lite cell's parts on the CPU: its mix is ``code_batch``
but for its driver, its counts give the published sizes, the driver reads
the configuration file into the registry's config, and a tiny run of the
cell (``harness/tiny.py``'s sizes, made an MLA + MoE model) gives the
contract's line."""
import dataclasses
import time

import pytest
import torch

from portbench import run as run_mod
from portbench.counts import mla_moe as MC
from portbench.drivers import lm_serve_moe as D
from portbench.harness import cell, tiny
from portbench.harness.env import BENCH_DIR

CELL = "serve_dsv2_lite_batch"
CONF = cell.load_json(BENCH_DIR / "configs" / "deepseek-v2-lite.json")
# an MLA + MoE model small enough for the CPU: layer 0 dense, two MoE
# layers of 8 experts top-3 with 2 shared; YaRN and raw gates as published
SMALL = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=4,
             kv_lora_rank=16, qk_nope_head_dim=8, qk_rope_head_dim=8,
             v_head_dim=8, n_routed_experts=8, num_experts_per_tok=3,
             n_shared_experts=2, moe_intermediate_size=32,
             intermediate_size=128, num_hidden_layers=3, vocab_size=512,
             dtype="float32")


def test_the_mix_is_code_batch_but_for_its_driver():
    a = cell.load_json(BENCH_DIR / "traffic" / "code_batch_moe.json")
    b = cell.load_json(BENCH_DIR / "traffic" / "code_batch.json")
    assert set(a) == set(b)
    assert {k: v for k, v in a.items() if k not in ("driver", "about")} == {
        k: v for k, v in b.items() if k not in ("driver", "about")}
    assert a["driver"] == "lm_serve_moe" and b["driver"] == "lm_serve"


def test_counts_at_the_published_sizes():
    """15.71 B parameters, 2.45 B a token (the head in, the input embedding
    out); every 64 x 3 x 2048 x 1408 expert weight of 26 layers is there;
    a token at position p costs twice its weights and 34816 operations a
    key and layer."""
    total, active = MC.param_counts(CONF)
    assert round(total / 1e9, 2) == 15.71 and round(active / 1e9, 2) == 2.45
    assert MC.expert_params(CONF) == 3 * 2048 * 1408
    assert total > 26 * 64 * MC.expert_params(CONF)
    from repro_torch.config import get_arch
    port_total, port_active = get_arch("deepseek-v2-lite").param_counts()
    # the registry's count leaves out the 27 latent norms, and counts the
    # input embedding as active
    assert total - port_total == 27 * 512
    assert port_active - active == 102400 * 2048 - 27 * 512
    assert MC.attention_flops(CONF, 1) == 2 * 16 * (2 * 512 + 64) * 27
    assert MC.forward_flops(CONF, 9, True) == (
        2.0 * MC.matmul_params(CONF, True) + MC.attention_flops(CONF, 10))
    assert MC.matmul_params(CONF, True) - MC.matmul_params(CONF, False) \
        == 2048 * 102400


def test_the_driver_reads_the_file_into_the_registrys_config():
    """Every size the file states, the MLA, MoE and YaRN ones included,
    gives the registry's ``deepseek-v2-lite`` field for field (dropless,
    raw gates); the reference's ``PORT_FORM`` holds; a routing the port
    does not compute is refused."""
    from repro_torch.config import get_arch
    from portbench.reference import deepseek_v2 as R
    cfg = D.model_config(CONF)
    want = get_arch("deepseek-v2-lite")
    assert cfg == want
    assert (cfg.moe.capacity_factor, cfg.moe.norm_topk_prob) == (None, False)
    assert cfg.rope_scaling == want.rope_scaling
    assert {k: getattr(cfg, k) for k in R.PORT_FORM} == R.PORT_FORM
    for bad in ({"routed_scaling_factor": 16}, {"topk_method": "group"},
                {"scoring_func": "sigmoid"}):
        with pytest.raises(SystemExit):
            D.model_config(dict(CONF, **bad))


def _spec():
    sp = tiny.spec(CELL)
    sp["config"].update(SMALL)
    return sp


def _run(trace=False, mode="program"):
    t = time.perf_counter()
    return run_mod.run_cell(torch, _spec(), seed=2 ** 31 + 23, seconds=6.0,
                            trace=trace, device=torch.device("cpu"),
                            t_process=t, mode=mode, ticks=100)


def test_tiny_run_is_correct_and_drops_nothing():
    line = _run()
    assert set(line["metrics"]) == {"tokens_per_s", "setup_s"}
    assert line["correct"], line["checks"]
    assert line["checks"]["moe_dropped"] == {"value": 0.0, "limit": 0}
    assert line["checks"]["token_gap"]["value"] < 1e-3
    assert line["attempted"] > 0 and line["failed"] == 0


def test_tiny_traced_run_reads_the_host_metrics():
    """On the CPU no device trace exists: the span and counter readers
    report (10.7 rows a copy is E / K at C = N: 8 / 3 here), the idle and
    roofline ones do not."""
    line = _run(trace=True)
    assert set(line["metrics"]) == {"serve.decode_tick_ms",
                                    "serve.prefill_ms_per_token",
                                    "mfu.serve_moe",
                                    "serve.moe_rows_per_copy"}
    assert line["metrics"]["serve.moe_rows_per_copy"]["value"] \
        == pytest.approx(8 / 3)


def test_a_capacity_that_drops_copies_is_not_correct(monkeypatch):
    """Served with GShard's capacity in place of dropless routing, the run
    counts its dropped copies and is refused."""
    orig = D.model_config

    def capped(config):
        cfg = orig(config)
        return dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=0.5))
    monkeypatch.setattr(D, "model_config", capped)
    line = _run()
    assert line["checks"]["moe_dropped"]["value"] > 0
    assert not line["correct"]


def test_control_is_not_correct():
    """The reference one precision below the configuration's (float8
    operands in every product, the router's included) in the program's
    place reads past ``token_gap``'s limit."""
    line = _run(mode="control")
    assert not line["correct"]
    c = line["checks"]["token_gap"]
    assert c["value"] > c["limit"]
