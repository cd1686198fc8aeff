"""zamba2-2.7b — Mamba2 backbone + shared attention blocks [arXiv:2411.15242].

54 Mamba2 layers, d_model=2560, ssm_state=64; a single SHARED full-attention
(+gated-MLP) block (32 heads, kv=32, d_ff=10240) is applied every 6 backbone
layers with the SAME weights (Zamba2's parameter-sharing trick).  vocab=32000.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b",
        family="hybrid",
        n_layers=54,
        d_model=2560,
        n_heads=32,
        n_kv_heads=32,
        head_dim=80,          # 2560 / 32
        d_ff=10240,
        vocab_size=32000,
        attn_every=6,         # shared attention block cadence
        ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk=128),
        microbatch=8,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="zamba2-smoke",
        family="hybrid",
        n_layers=4,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=128,
        attn_every=2,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, chunk=32),
        attn_chunk=64,
    )
