"""Data pipeline: synthetic dash-cam data (numpy; feeds the tests, the
examples and ``chip_smoke.py``) and device prefetch."""
from repro_torch.data.synthetic import (DashCamSource, VideoPair,  # noqa: F401
                                        frame_loop, synth_frames)
from repro_torch.data.prefetch import device_prefetch  # noqa: F401
