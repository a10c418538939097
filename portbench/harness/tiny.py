"""CPU-size variants of the cells, for the tests in ``portbench/``.

Each keeps the cell's configuration, mix and driver and shrinks what a CPU
run cannot hold: the language model's widths and depth, the engine's slots
and the request and batch sizes.  The limits stay the cell's.  A tiny
window is a fixed number of ticks, not of seconds, so that a loaded machine
finishes the same requests as an idle one.
"""
from __future__ import annotations

import time

from portbench.harness import cell

LM_TINY = dict(hidden_size=512, intermediate_size=1024, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=2, vocab_size=512)
# served: wide and deep enough, and enough served tokens, that the control's
# float8 products move some token's logit past the cell's limit; float32, as
# the CPU's bfloat16 products are slow
LM_SERVE = dict(hidden_size=1024, intermediate_size=2048, num_hidden_layers=4,
                num_attention_heads=8, num_key_value_heads=2, vocab_size=4096,
                sliding_window=256, dtype="float32")


def spec(workload: str, root=None) -> dict:
    sp = cell.load_cell(workload) if root is None else cell.load_cell(
        workload, root)
    mix, config = sp["mix"], sp["config"]
    if mix["kind"] == "lm_batch":
        config.update(LM_SERVE)
        mix["engine"].update(slots=4, cache_capacity=256, num_blocks=64,
                             prefill_chunk=16)
        mix.update(initial=4, queued=2, stratum=4, block=2)
        mix["prompt"].update(median=16, min=4, max=64)
        mix["output"].update(min=32, max=64)
        mix["initial_output"].update(min=32, max=64)
        mix["check"] = {"requests": 8}
    elif mix["kind"] == "lm_pretrain":
        # float32 parameters: at these widths an update is a fraction of a
        # bfloat16 spacing, and the change would be all rounding
        config.update(LM_TINY, dtype="float32")
        mix.update(batch=4, seq=16, max_step_s=0.05)
    return sp


#: window seconds of a tiny run of each kind; the served cell's window is
#: TICKS ticks instead, enough to finish the requests the check compares
SECONDS = {"lm_batch": 6.0, "lm_pretrain": 0.3}
TICKS = {"lm_batch": 100}


def run(torch, workload: str, *, seed: int = 2 ** 31 + 11,
        seconds: float = None, trace: bool = False, mode: str = "program",
        root=None):
    """One CPU run of the tiny cell; the result line's object.  Given
    ``seconds``, the window lasts that long whatever its kind."""
    from portbench import run as run_mod
    t = time.perf_counter()
    sp = spec(workload, root)
    kind = sp["mix"]["kind"]
    ticks = TICKS.get(kind) if seconds is None else None
    return run_mod.run_cell(torch, sp, seed=seed,
                            seconds=seconds or SECONDS[kind], trace=trace,
                            device=torch.device("cpu"), t_process=t,
                            mode=mode, ticks=ticks)
