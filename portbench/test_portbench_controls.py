"""``correct`` fails where it must, at the tiny sizes on the CPU: the
control (the reference one precision below the configuration's, in the
program's place) and each fault a cell can have, planted in the program
underneath a whole run (the look for a card is skipped)."""
import pytest
import torch

from portbench.harness import tiny


def _failed(line):
    return [k for k, c in line["checks"].items() if not c["value"] <= c["limit"]]


@pytest.mark.parametrize("workload", ["serve_sc2_3b_batch", "train_sc2_3b"])
def test_control_is_not_correct(workload):
    line = tiny.run(torch, workload, mode="control")
    assert not line["correct"] and _failed(line), line["checks"]


def test_serve_token_altered_where_it_is_produced(monkeypatch):
    from repro_torch.serving import engine as E
    calls = {"n": 0}

    def sample(logits):
        calls["n"] += 1
        tok = torch.argmax(logits, dim=-1)
        return (tok + 1) % logits.shape[-1] if calls["n"] % 5 == 0 else tok
    monkeypatch.setattr(E, "_argmax_sample", sample)
    line = tiny.run(torch, "serve_sc2_3b_batch")
    assert "token_gap" in _failed(line)


def test_train_step_that_returns_its_state_unchanged(monkeypatch):
    from repro_torch.train import train_step as TS
    monkeypatch.setattr(
        TS, "adamw_update",
        lambda cfg, grads, params, state: (
            params, state, {"grad_norm": torch.zeros(()),
                            "lr": torch.zeros(())}))
    line = tiny.run(torch, "train_sc2_3b")
    assert {"grad_gap", "change_gap"} <= set(_failed(line))
    assert line["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_train_half_of_the_batch_left_out(monkeypatch):
    from repro_torch.train import train_step as TS
    orig = TS._microbatch
    monkeypatch.setattr(TS, "_microbatch",
                        lambda batch, i, accum: orig(batch, 0, accum))
    line = tiny.run(torch, "train_sc2_3b")
    assert not line["correct"], line["checks"]
