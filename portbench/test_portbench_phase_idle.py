"""The readers of the card's idle time under the token engine's phase
spans (``metrics/serve.decode_forward_idle_ms.py`` and
``metrics/serve.prefill_forward_idle_ms_per_token.py``) on a synthetic
record, checked by hand."""
import pytest

from portbench.harness import cell

IDLE = {
    "decode.forward": 0.5,
    "decode.forward / cudaLaunchKernel": 0.25,
    "decode.forward / cuLaunchKernelEx": 0.05,
    "prefill.forward": 1.2,
    "prefill.forward / cudaLaunchKernel": 0.3,
    # labels neither reader counts: other spans, a span whose name only
    # begins like one of the two, and a runtime call named like a span
    "decode": 2.0,
    "decode / cudaMemcpyAsync": 0.4,
    "decode.read": 0.1,
    "decode.forward_x": 9.0,
    "prefill": 3.0,
    "prefill.upload / cudaMemcpyAsync": 0.7,
    "step / decode.forward": 5.0,
    "outside any span": 0.2,
}


def _record(trace=True, idle=IDLE):
    return {"spans": {"decode": [80.0] * 4, "prefill": [300.0, 500.0]},
            "trace": {"idle": dict(idle), "busy_s": 1.0, "window_s": 30.0,
                      "kernels": {}} if trace else None,
            "counts": {"prompt_tokens": 600}, "window_s": 30.0}


def _read(name, record):
    return cell.metric_reader(name)(record)


def test_decode_forward_idle_per_decode_tick():
    # (0.5 + 0.25 + 0.05) s over 4 decode spans
    assert _read("serve.decode_forward_idle_ms",
                 _record()) == pytest.approx(200.0)


def test_prefill_forward_idle_per_prompt_token():
    # (1.2 + 0.3) s over 600 prompt tokens
    assert _read("serve.prefill_forward_idle_ms_per_token",
                 _record()) == pytest.approx(2.5)


@pytest.mark.parametrize("name", ["serve.decode_forward_idle_ms",
                                  "serve.prefill_forward_idle_ms_per_token"])
def test_nothing_to_read_gives_none(name):
    # no device trace (the CPU, or --trace 0)
    assert _read(name, _record(trace=False)) is None
    # a program without the phase spans: no gap carries their labels
    old = {k: v for k, v in IDLE.items() if ".forward" not in k}
    assert _read(name, _record(idle=old)) is None
    # no decode span, no prompt token
    assert _read(name, {"spans": {}, "trace": _record()["trace"],
                        "counts": {}, "window_s": 30.0}) is None
