"""whisper-base [audio] — enc-dec transformer backbone, conv frontend STUB.

6L (x2: encoder+decoder) d_model=512 8H (kv=8) d_ff=2048 vocab=51865
[arXiv:2212.04356].  The audio frontend (log-mel + conv) is a stub, as in
the reference: callers pass precomputed frame embeddings (B, 1500, 512) as
``extras={"frames": ...}``.  Positions are sinusoidal (computed, any
length) instead of Whisper's learned decoder table, as in the reference.
"""
from repro_torch.config import ModelConfig, register_arch


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-base",
        family="encdec",
        num_layers=6,               # decoder layers
        num_encoder_layers=6,
        encoder_seq=1500,
        d_model=512,
        num_heads=8,
        num_kv_heads=8,
        head_dim=64,
        d_ff=2048,
        vocab_size=51865,
        attention="full",
        rope=False,                 # sinusoidal absolute positions
        qkv_bias=True,
        o_bias=True,
        norm="layernorm",
        norm_eps=1e-5,
        mlp="gelu_mlp",
        mlp_bias=True,
        tie_embeddings=True,
    )


register_arch("whisper-base", config)
