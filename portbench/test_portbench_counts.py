"""The frozen operation and byte counts against shapes worked by hand."""
import pytest

from portbench.counts import lm as LC
from portbench.harness.cell import load_json
from portbench.harness.env import BENCH_DIR

SC2 = load_json(BENCH_DIR / "configs" / "starcoder2-3b.json")


def test_starcoder2_parameters_and_forward_flops():
    per_layer = (3072 * (3072 + 2 * 256) + 3072 * 3072 + 2 * 3072 * 12288)
    assert LC.layer_matmul_params(SC2) == per_layer
    assert LC.unembed_params(SC2) == 3072 * 49152
    # 3.03 B parameters with embeddings, biases and norms
    total = per_layer * 30 + 3072 * 49152
    assert 2.9e9 < total < 3.05e9
    f = LC.forward_flops(SC2, 9, True)
    assert f == 2.0 * (per_layer * 30 + 3072 * 49152) + 4 * 24 * 128 * 10 * 30


def test_attention_counts_by_hand():
    assert LC.keys_seen(SC2, 0) == 1
    assert LC.keys_seen(SC2, 9999) == 4096
    kv = 100 * (2 * 128 * 2 * 2 + 4)
    q = 2 * 24 * 128 * 2
    assert LC.decode_attention_bytes(SC2, 100) == (kv + q) * 30
    f, b = LC.prefill_attention(SC2, 3)
    assert f == 4 * 24 * 128 * (1 + 2 + 3) * 30
    assert b == (3 * (2 * 128 * 2 * 2 + 4) + 2 * 3 * 24 * 128 * 2) * 30


def test_train_step_flops_is_three_forwards_of_every_token():
    one = sum(LC.forward_flops(SC2, p, True) for p in range(512))
    assert LC.train_step_flops(SC2, 8, 512) == pytest.approx(3 * 8 * one)
    # about 6 N per token at N ~ 3 B
    per_token = LC.train_step_flops(SC2, 8, 512) / (8 * 512)
    assert 5.5 * 2.9e9 < per_token < 6.5 * 3.1e9
