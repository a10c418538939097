"""starcoder2-3b [dense] — 30L d_model=3072 24H (GQA kv=2) d_ff=12288
vocab=49152; GQA + RoPE + sliding-window 4096 [arXiv:2402.19173].
"""
from repro_torch.config import ModelConfig, register_arch


def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-3b",
        family="dense",
        num_layers=30,
        d_model=3072,
        num_heads=24,
        num_kv_heads=2,
        head_dim=128,
        d_ff=12288,
        vocab_size=49152,
        attention="sliding",
        window=4096,
        rope=True,
        rope_theta=1e5,
        qkv_bias=True,
        o_bias=True,
        norm="layernorm",
        norm_eps=1e-5,
        mlp="gelu_mlp",
        mlp_bias=True,
        tie_embeddings=True,
    )


register_arch("starcoder2-3b", config)
