"""End-to-end driver: EDA analysing synthetic dash-cam video with real
inference through the PyTorch port (the paper's case study, §3.2.3).

The master downloads (outer, inner) clip pairs from the synthetic dash
cam, the capacity scheduler places them across the paper's three phones
(findx2pro master, pixel6, oneplus8), segmentation splits clips, early
stopping enforces the per-video deadline, and the detector and pose
models (``repro_torch.models.vision``) produce hazard and distraction
flags frame by frame.  The models run on the card unless ``--device cpu``
is given; their weights are drawn from a seeded ``torch.Generator``.

    PYTHONPATH=src python examples/torch_eda_dashcam_serve.py [--pairs 8]
    PYTHONPATH=src python examples/torch_eda_dashcam_serve.py --device cpu
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.config import EDAConfig
from repro_torch.configs.eda_vision import detector_config, pose_config
from repro_torch.core.runtime import PAPER_DEVICES, EDARuntime
from repro_torch.core.segmentation import Segment
from repro_torch.data import DashCamSource
from repro_torch.device import resolve_device
from repro_torch.models import vision as V


class RealExecutor:
    """Actual model inference with per-device speed emulation: the
    measured wall time of a segment, divided by the phone's relative
    speed, is its processing time.

    ``params`` is a ``(detector, pose)`` pair already on ``device``;
    without it both are drawn on ``device`` from ``seed``.
    """

    SPEED = {"pixel3": 0.45, "pixel6": 0.75, "oneplus8": 1.0,
             "findx2pro": 1.1}

    def __init__(self, source: DashCamSource, res: int = 96, device=None,
                 seed: int = 0, params=None):
        self.device = resolve_device(device)
        self.dc, self.pc = detector_config(res), pose_config(res)
        if params is None:
            gen = torch.Generator().manual_seed(seed)
            params = (V.init_detector(self.dc, gen, device=self.device),
                      V.init_pose(self.pc, gen, device=self.device))
        self.dp, self.pp = params
        self.source = source

    def frame_cost_ms(self, device, stream, frames=30):
        return 6.0 / self.SPEED[device]

    def flags(self, stream: str, clip: np.ndarray) -> np.ndarray:
        """Per-frame danger flags of ``clip`` (frames, H, W, 3): any hazard
        box (outer) or a distracted driver (inner)."""
        frames = torch.as_tensor(clip).to(self.device)
        if stream == "outer":
            flags, _ = V.analyse_outer(self.dc, self.dp, frames)
            flags = flags.any(dim=1)
        else:
            flags, _ = V.analyse_inner(self.pc, self.pp, frames)
        return flags.cpu().numpy()

    def run(self, device, seg: Segment, budget: int):
        n = min(budget, seg.frame_count)
        if n == 0:
            return 0, 0.0, {}
        pair = self.source.pair(int(seg.video_id.split("_")[0][1:]))
        clip = (pair.outer if seg.stream == "outer" else
                pair.inner)[seg.frame_start: seg.frame_start + n]
        t0 = time.perf_counter()
        per_frame = self.flags(seg.stream, clip)     # the copy back syncs
        wall = (time.perf_counter() - t0) * 1000 / self.SPEED[device]
        return n, wall, {i: {"danger": bool(per_frame[i])} for i in range(n)}


def paper_runtime(executor, fps: int) -> EDARuntime:
    """The paper's three phones at 1 s granularity with segmentation and
    dynamic ESD (the 0.35 s simulated download of its 1 s tests)."""
    return EDARuntime(
        eda=EDAConfig(granularity_s=1.0, fps=fps, simulate_download_s=0.35,
                      segmentation=True, dynamic_esd=True),
        master=PAPER_DEVICES["findx2pro"],
        workers=[PAPER_DEVICES["pixel6"], PAPER_DEVICES["oneplus8"]],
        executor=executor)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=8)
    ap.add_argument("--fps", type=int, default=6)
    ap.add_argument("--frame-res", type=int, default=96,
                    help="dash-cam frame size (px)")
    ap.add_argument("--res", type=int, default=96,
                    help="model input size (px)")
    ap.add_argument("--device", default=None,
                    help="torch device; default the card, 'cpu' for the CPU")
    args = ap.parse_args()

    src = DashCamSource(granularity_s=1.0, fps=args.fps, res=args.frame_res,
                        seed=7)
    rt = paper_runtime(RealExecutor(src, res=args.res, device=args.device),
                       args.fps)
    ledger = rt.run(args.pairs)

    print(ledger.table())
    print()
    for vid in sorted(rt.results):
        frames = rt.results[vid]
        danger = [i for i, r in sorted(frames.items()) if r["danger"]]
        kind = "hazard" if "_out" in vid else "distraction"
        status = f"{kind} frames {danger}" if danger else "clear"
        print(f"{vid:16s} {len(frames):3d} frames analysed  -> {status}")
    print(f"\nnear-real-time fraction: {ledger.real_time_fraction():.0%}")


if __name__ == "__main__":
    main()
