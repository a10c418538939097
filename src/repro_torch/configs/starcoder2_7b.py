"""starcoder2-7b [dense] — 32L d_model=4608 36H (GQA kv=4) d_ff=18432
vocab=49152; GQA + RoPE + sliding-window 4096 attention, LayerNorm, biased
projections, plain GeLU MLP [arXiv:2402.19173; hf:bigcode/starcoder2-7b].
"""
from repro_torch.config import ModelConfig, register_arch


def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-7b",
        family="dense",
        num_layers=32,
        d_model=4608,
        num_heads=36,
        num_kv_heads=4,
        head_dim=128,
        d_ff=18432,
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


register_arch("starcoder2-7b", config)
