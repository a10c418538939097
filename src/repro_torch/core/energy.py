"""Energy proxy model (paper §4.2.3 adaptation).

The paper reads Android's battery API (mW per video, % battery per run).
Without physical phones we model energy from first principles:

  E(segment) = flops * J_per_gflop(device) / 1e9
             + bytes_moved * J_per_gb / 2**30
             + active_seconds * idle_w

calibrated per device class so the paper's *relative ordering* reproduces
(Find X2 Pro > OnePlus 8 >> Pixel 6 ~ Pixel 3, Tables 4.8/4.9) — the
absolute mW values are hardware-bound; EXPERIMENTS.md reports ours
side-by-side with the paper's.

The same interface computes the TPU-side energy estimate for worker groups
(J/FLOP from chip TDP / peak FLOPs), used by the serving engine's
energy-aware placement (beyond-paper feature).
"""
from __future__ import annotations

from dataclasses import dataclass

J_PER_GB_WIFI = 0.5       # marginal radio cost per GiB over Wi-Fi Direct
BATTERY_V = 3.7           # nominal Li-ion cell voltage
SCREEN_W = 2.0            # always-on draw during a run (screen + radios);
                          # enters battery %, not the per-video mW metric


@dataclass(frozen=True)
class DeviceEnergy:
    name: str
    j_per_gflop: float       # marginal compute energy (above idle)
    active_w: float          # extra SoC draw while analysing
    battery_mah: float

    def battery_j(self) -> float:
        return self.battery_mah / 1000.0 * BATTERY_V * 3600.0


# Calibrated to the paper's per-video mW metric (Table 4.8, one-node 1 s:
# pixel3 19.2 / pixel6 35.9 / oneplus8 110.2 / findx2pro 172.8 mW) — the
# Android battery API reports *incremental* power, hence the small J/GFLOP.
# The ordering is the physics the model must keep: flagship SoCs (Snapdragon
# 865) burn several times the Pixels' power for the same frames.
DEVICE_ENERGY = {
    "pixel3": DeviceEnergy("pixel3", j_per_gflop=0.0020, active_w=0.010,
                           battery_mah=2915),
    "pixel6": DeviceEnergy("pixel6", j_per_gflop=0.0016, active_w=0.012,
                           battery_mah=4614),
    "oneplus8": DeviceEnergy("oneplus8", j_per_gflop=0.0045, active_w=0.020,
                             battery_mah=4300),
    "findx2pro": DeviceEnergy("findx2pro", j_per_gflop=0.0070, active_w=0.030,
                              battery_mah=4260),
}

# TPU v5e: ~200 W chip at 197 TFLOP/s bf16 peak -> ~1e-12 J/FLOP at peak,
# i.e. ~0.001 J/GFLOP, three orders below phones — the quantitative argument
# for *why* the pod analogue of EDA schedules by capacity, not energy.
TPU_V5E = DeviceEnergy("tpu-v5e", j_per_gflop=0.001, active_w=60.0,
                       battery_mah=0)


class EnergyModel:
    def __init__(self, table: dict = None,
                 j_per_gb: float = J_PER_GB_WIFI) -> None:
        self.table = dict(table or DEVICE_ENERGY)
        self.j_per_gb = j_per_gb

    def segment_energy_j(self, device_class: str, flops: float,
                         bytes_moved: float, active_s: float) -> float:
        d = self.table[device_class]
        return (flops / 1e9 * d.j_per_gflop
                + bytes_moved / 2 ** 30 * self.j_per_gb
                + active_s * d.active_w)

    def battery_pct(self, device_class: str, energy_j: float,
                    wall_s: float = 0.0, screen_w: float = SCREEN_W) -> float:
        """Battery consumed over a run: marginal analysis energy + the
        always-on draw for the run's wall time (the paper's 1-8%/run)."""
        cap = self.table[device_class].battery_j()
        if cap <= 0:
            return 0.0
        return 100.0 * (energy_j + wall_s * screen_w) / cap
