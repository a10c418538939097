"""The card's idle ms under the program's ``decode.forward`` spans
(``serving/engine.py`` ``step``: the model step and sampling as the host
enqueues them), a CUDA runtime call under way or not, over the number of
``decode`` spans: the card starved while the host enqueues one decode tick.
None without a device trace, or where no idle gap falls under that span."""
from portbench.harness.readers import span_ms


def read(record):
    trace = record.get("trace")
    ticks = len(span_ms(record, "decode"))
    if not trace or not ticks:
        return None
    idle_s = sum(v for label, v in trace["idle"].items()
                 if label.split(" / ", 1)[0] == "decode.forward")
    return 1e3 * idle_s / ticks if idle_s > 0 else None
