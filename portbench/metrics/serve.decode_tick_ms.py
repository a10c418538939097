"""Mean host ms of the program's ``decode`` spans (``serving/engine.py``
``step``: one token for every active slot, ending in the sampled ids' read
from the card)."""
from portbench.harness.readers import span_ms


def read(record):
    spans = span_ms(record, "decode")
    return sum(spans) / len(spans) if spans else None
