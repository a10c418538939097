"""internvl2-2b [vlm] — 24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553;
InternViT frontend STUB + InternLM2-1.8B backbone [arXiv:2404.16821;
hf:OpenGVLab/InternVL2-2B].  As in the reference, callers pass precomputed
patch embeddings (256 per image) as ``extras={"patches": ...}``, which the
model projects and writes over the prompt's first 256 embeddings.
"""
from repro_torch.config import ModelConfig, register_arch


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-2b",
        family="vlm",
        num_layers=24,
        d_model=2048,
        num_heads=16,
        num_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=92553,
        attention="full",
        rope=True,
        rope_theta=1e6,
        norm="rmsnorm",
        mlp="swiglu",
        num_patches=256,
    )


register_arch("internvl2-2b", config)
