"""Per-architecture configs the port serves.

Importing this package registers each ported arch with
``repro_torch.config``.  Only the pure-attention ``starcoder2-3b`` is
ported so far; the other architectures of the reference's registry come
with the model families that run them (``ROADMAP.md`` queue 1, item 11).
"""
from repro_torch.configs import starcoder2_3b  # noqa: F401
