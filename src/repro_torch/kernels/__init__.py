"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version.

``vision_ops`` ports the reference's frame-ingest Pallas suite
(``ingest_frame``, ``scatter_admit``, ``downscale``, ``block_sad``) from
``csrc/vision_ops.cu``; ``build`` compiles a ``csrc`` source with ``nvcc``
at first use and loads it with ``ctypes``.  The attention, RG-LRU and
mLSTM kernels of the reference are not ported yet (``ROADMAP.md``).
"""
