"""command-r-plus-104b [dense] — 64L d_model=12288 96H (GQA kv=8) d_ff=33792
vocab=256000; GQA, no-bias, parallel attention+FFN block, LayerNorm (no bias),
tied embeddings [hf:CohereForAI/c4ai-command-r-plus].

As in the reference, ``norm="layernorm"`` declares a bias leaf for every
norm, initialised to zeros (``layers.norm_params``), so a freshly drawn
model's norms are bias-free; the parallel block feeds one norm's output
to both attention and MLP and adds both to the residual.
"""
from repro_torch.config import ModelConfig, register_arch


def config() -> ModelConfig:
    return ModelConfig(
        name="command-r-plus-104b",
        family="dense",
        num_layers=64,
        d_model=12288,
        num_heads=96,
        num_kv_heads=8,
        head_dim=128,
        d_ff=33792,
        vocab_size=256000,
        attention="full",
        rope=True,
        rope_theta=75e6,
        qkv_bias=False,
        norm="layernorm",
        norm_eps=1e-5,
        mlp="swiglu",
        parallel_block=True,
        tie_embeddings=True,
    )


register_arch("command-r-plus-104b", config)
