"""Synthetic dash-cam data (numpy; feeds the tests and ``chip_smoke.py``)."""
from repro_torch.data.synthetic import (DashCamSource, VideoPair,  # noqa: F401
                                        frame_loop, synth_frames)
