"""granite-moe-1b-a400m [moe] — 24L d_model=1024 16H (GQA kv=8), MoE 32
experts top-8, expert d_ff=512, vocab=49155
[hf:ibm-granite/granite-3.0-1b-a400m-base].
"""
from repro_torch.config import MoEConfig, ModelConfig, register_arch


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m",
        family="moe",
        num_layers=24,
        d_model=1024,
        num_heads=16,
        num_kv_heads=8,
        head_dim=64,
        d_ff=512,
        vocab_size=49155,
        attention="full",
        moe=MoEConfig(num_experts=32, top_k=8, num_shared_experts=0,
                      expert_ff=512, first_dense_layers=0),
        rope=True,
        rope_theta=1e4,
        norm="rmsnorm",
        mlp="swiglu",
        tie_embeddings=True,
    )


register_arch("granite-moe-1b-a400m", config)
