"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version.

``vision_ops`` ports the reference's frame-ingest Pallas suite
(``ingest_frame``, ``scatter_admit``, ``downscale``, ``block_sad``) from
``csrc/vision_ops.cu``.  ``paged_attention``, ``flash_attention`` and
``decode_attention`` port its four attention kernels from
``csrc/attention.cu`` (the two flash kernels) and
``csrc/decode_attention.cu`` (the two decode kernels; shared pieces in
``attention_common``);
``rglru`` and ``mlstm`` port its RG-LRU scan and chunkwise mLSTM from
``csrc/recurrent.cu``; ``ops`` routes the model's calls to them as the
reference's ``kernels/ops.py`` does.  ``build`` compiles a ``csrc`` source
with ``nvcc`` at first use and loads it with ``ctypes``.
"""
