"""Host ms of the program's ``prefill`` spans (``_admit`` and
``_prefill_loop``) over the prompt tokens they prefilled in the window."""
from portbench.harness.readers import span_ms


def read(record):
    spans = span_ms(record, "prefill")
    tokens = record["counts"].get("prompt_tokens")
    return sum(spans) / tokens if spans and tokens else None
