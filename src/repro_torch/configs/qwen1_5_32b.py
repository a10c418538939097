"""qwen1.5-32b [dense] — 64L d_model=5120 40H (kv=40) d_ff=27392 vocab=152064;
QKV bias, RMSNorm, SwiGLU, full attention, RoPE [hf:Qwen/Qwen1.5-32B].
"""
from repro_torch.config import ModelConfig, register_arch


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-32b",
        family="dense",
        num_layers=64,
        d_model=5120,
        num_heads=40,
        num_kv_heads=40,
        head_dim=128,
        d_ff=27392,
        vocab_size=152064,
        attention="full",
        rope=True,
        rope_theta=1e6,
        qkv_bias=True,
        norm="rmsnorm",
        mlp="swiglu",
    )


register_arch("qwen1.5-32b", config)
