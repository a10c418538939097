"""The least time of the window's attention (``counts/lm.py``: each decode
and each prompt's causal attention, the larger of bytes over 3.35 TB/s and
operations over 989 TFLOP/s) over the device time of the attention kernels
in the trace (``decode_kernel`` of ``csrc/decode_attention.cu``,
``flash_kernel`` of ``csrc/attention.cu``: kernels 5 and 6 on the paged
pool), in percent."""
from portbench.harness.readers import device_seconds, share_percent


def read(record):
    return share_percent(record["counts"].get("attn_bound_s", 0.0),
                         device_seconds(record,
                                        r"\bdecode_kernel\b|\bflash_kernel\b"))
