"""deepseek-v2-236b [moe] — 60L d_model=5120 128H, MLA kv_lora=512, MoE with
2 shared + 160 routed experts top-6, expert d_ff=1536, vocab=102400
[arXiv:2405.04434; hf:deepseek-ai/DeepSeek-V2].

d_ff for the first (dense) layer is 12288 per the HF config; the assigned
``d_ff=1536`` is the per-expert intermediate size.
"""
from repro_torch.config import MLAConfig, MoEConfig, ModelConfig, register_arch


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b",
        family="moe",
        num_layers=60,
        d_model=5120,
        num_heads=128,
        num_kv_heads=128,
        head_dim=192,               # qk_nope(128) + qk_rope(64)
        d_ff=12288,                 # dense layers (layer 0)
        vocab_size=102400,
        attention="mla",
        mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                      qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128),
        moe=MoEConfig(num_experts=160, top_k=6, num_shared_experts=2,
                      expert_ff=1536, first_dense_layers=1),
        rope=True,
        rope_theta=1e4,
        norm="rmsnorm",
        mlp="swiglu",
    )


register_arch("deepseek-v2-236b", config)
