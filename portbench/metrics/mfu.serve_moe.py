"""Model operations of the window's prompt and output tokens
(``counts/mla_moe.py``: the active parameters a token multiplies with, and
absorbed MLA attention a key) over the window times 989 TFLOP/s of bf16, in
percent."""
from portbench.counts.peaks import BF16_FLOPS
from portbench.harness.readers import share_percent


def read(record):
    return share_percent(record["counts"].get("model_flops", 0.0),
                         record["window_s"] * BF16_FLOPS)
