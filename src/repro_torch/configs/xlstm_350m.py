"""xlstm-350m [ssm] — 24L d_model=1024 4H d_ff=0 vocab=50304; sLSTM + mLSTM
blocks in a 7:1 mLSTM:sLSTM pattern [arXiv:2405.04517].  d_ff=0: xLSTM blocks
carry their own up/down projections (mLSTM proj_factor 2.0; sLSTM 4/3 GeLU
FFN), so there is no separate transformer MLP.
"""
from repro_torch.config import MLSTM, SLSTM, ModelConfig, register_arch


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m",
        family="ssm",
        num_layers=24,
        d_model=1024,
        num_heads=4,
        num_kv_heads=4,
        head_dim=256,
        d_ff=0,
        vocab_size=50304,
        attention="full",  # unused: all blocks recurrent
        rope=False,
        block_pattern=(MLSTM,) * 7 + (SLSTM,),
        mlstm_proj_factor=2.0,
        slstm_proj_factor=1.3333,
        mlstm_chunk=64,
        norm="layernorm",
        tie_embeddings=False,
    )


register_arch("xlstm-350m", config)
