"""The card's idle ms under the program's ``prefill.forward`` spans
(``serving/engine.py`` ``_prefill_loop``: one chunk's forward as the host
enqueues it), a CUDA runtime call under way or not, over the prompt tokens
prefilled in the window.  None without a device trace, or where no idle gap
falls under that span."""


def read(record):
    trace = record.get("trace")
    tokens = record["counts"].get("prompt_tokens")
    if not trace or not tokens:
        return None
    idle_s = sum(v for label, v in trace["idle"].items()
                 if label.split(" / ", 1)[0] == "prefill.forward")
    return 1e3 * idle_s / tokens if idle_s > 0 else None
