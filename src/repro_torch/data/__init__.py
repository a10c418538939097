"""Data pipeline: synthetic dash-cam data and the LM token stream (numpy;
feed the tests, the examples, the train launcher and ``chip_smoke.py``)
and device prefetch."""
from repro_torch.data.synthetic import (DashCamSource, VideoPair,  # noqa: F401
                                        frame_loop, lm_batches,
                                        synth_frames)
from repro_torch.data.prefetch import device_prefetch  # noqa: F401
