"""The card's idle ms under the program's ``moe`` spans (``models/moe.py``
as ``transformer._apply_block`` runs it: routing, dispatch, the expert
products, the combine and the shared experts, as the host enqueues them),
a CUDA runtime call under way or not, over the number of ``decode`` spans.
In the window every prefill chunk is a CUDA graph's replay, which opens no
span, so every ``moe`` span is a decode tick's.  None without a device
trace, or where no idle gap falls under that span."""
from portbench.harness.readers import span_ms


def read(record):
    trace = record.get("trace")
    ticks = len(span_ms(record, "decode"))
    if not trace or not ticks:
        return None
    idle_s = sum(v for label, v in trace["idle"].items()
                 if label.split(" / ", 1)[0] == "moe")
    return 1e3 * idle_s / ticks if idle_s > 0 else None
