"""Per-architecture configs the port serves.

Importing this package registers each ported arch with
``repro_torch.config``: the pure-attention ``starcoder2-3b``, the hybrid
RG-LRU + local-attention ``recurrentgemma-9b`` and the mLSTM + sLSTM
``xlstm-350m``.  The other architectures of the reference's registry (MoE,
MLA, encoder-decoder, VLM) come with the model families that run them
(``ROADMAP.md`` queue 1, item 11).
"""
from repro_torch.configs import recurrentgemma_9b  # noqa: F401
from repro_torch.configs import starcoder2_3b  # noqa: F401
from repro_torch.configs import xlstm_350m  # noqa: F401
