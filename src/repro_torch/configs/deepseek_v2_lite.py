"""deepseek-v2-lite [moe] — 27L d_model=2048 16H, MLA kv_lora=512 (no
q_lora), one dense SwiGLU layer (d_ff=10944) then 26 MoE layers of 2
shared + 64 routed experts top-6, expert d_ff=1408, softmax routing with
the raw top-6 probabilities (``norm_topk_prob: false``), served dropless;
YaRN rope (factor 40 over 4096 positions, beta 32/1, mscale 0.707 on both);
vocab=102400, untied [arXiv:2405.04434;
hf:deepseek-ai/DeepSeek-V2-Lite/blob/main/config.json].

15.71 B parameters, 2.45 B active a token (the head included, the input
embedding not); one card holds it whole in bfloat16.
"""
from repro_torch.config import (MLAConfig, MoEConfig, ModelConfig,
                                RopeScaling, register_arch)


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite",
        family="moe",
        num_layers=27,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=192,               # qk_nope(128) + qk_rope(64)
        d_ff=10944,                 # the dense layer 0
        vocab_size=102400,
        attention="mla",
        mla=MLAConfig(q_lora_rank=0, kv_lora_rank=512, qk_nope_dim=128,
                      qk_rope_dim=64, v_head_dim=128),
        moe=MoEConfig(num_experts=64, top_k=6, num_shared_experts=2,
                      expert_ff=1408, first_dense_layers=1,
                      norm_topk_prob=False, capacity_factor=None),
        rope=True,
        rope_theta=1e4,
        rope_scaling=RopeScaling(factor=40.0, original_max_position=4096,
                                 beta_fast=32.0, beta_slow=1.0,
                                 mscale=0.707, mscale_all_dim=0.707),
        norm="rmsnorm",
        norm_eps=1e-6,
        mlp="swiglu",
    )


register_arch("deepseek-v2-lite", config)
