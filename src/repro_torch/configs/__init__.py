"""Per-architecture configs the port serves: every arch of the reference
registry.

Importing this package registers each arch with ``repro_torch.config``:
the dense attention stacks ``starcoder2-3b``, ``starcoder2-7b``,
``qwen1.5-32b`` and ``command-r-plus-104b``, the MoE
``granite-moe-1b-a400m``, the MLA + MoE ``deepseek-v2-236b``, the hybrid
RG-LRU + local-attention ``recurrentgemma-9b``, the mLSTM + sLSTM
``xlstm-350m``, the encoder-decoder ``whisper-base`` and the VLM
``internvl2-2b``.
"""
from repro_torch.configs import command_r_plus_104b  # noqa: F401
from repro_torch.configs import deepseek_v2_236b  # noqa: F401
from repro_torch.configs import granite_moe_1b_a400m  # noqa: F401
from repro_torch.configs import internvl2_2b  # noqa: F401
from repro_torch.configs import qwen1_5_32b  # noqa: F401
from repro_torch.configs import recurrentgemma_9b  # noqa: F401
from repro_torch.configs import starcoder2_3b  # noqa: F401
from repro_torch.configs import starcoder2_7b  # noqa: F401
from repro_torch.configs import whisper_base  # noqa: F401
from repro_torch.configs import xlstm_350m  # noqa: F401

# the dry-run's arch order (the reference's ``ASSIGNED``)
ASSIGNED = [
    "whisper-base",
    "starcoder2-7b",
    "qwen1.5-32b",
    "starcoder2-3b",
    "command-r-plus-104b",
    "xlstm-350m",
    "deepseek-v2-236b",
    "granite-moe-1b-a400m",
    "recurrentgemma-9b",
    "internvl2-2b",
]
