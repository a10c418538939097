"""recurrentgemma-9b [hybrid] — 38L d_model=4096 16H (MQA kv=1) d_ff=12288
vocab=256000; RG-LRU + local attention in a 2:1 (recurrent:attention) Griffin
pattern, window 2048, GeGLU MLP [arXiv:2402.19427].
"""
from repro_torch.config import ATTN, RGLRU, ModelConfig, register_arch


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b",
        family="hybrid",
        num_layers=38,
        d_model=4096,
        num_heads=16,
        num_kv_heads=1,
        head_dim=256,
        d_ff=12288,
        vocab_size=256000,
        attention="sliding",
        window=2048,
        rope=True,
        rope_theta=1e4,
        block_pattern=(RGLRU, RGLRU, ATTN),
        conv_width=4,
        lru_width=4096,
        norm="rmsnorm",
        mlp="geglu",
        tie_embeddings=True,
        logit_softcap=30.0,
    )


register_arch("recurrentgemma-9b", config)
