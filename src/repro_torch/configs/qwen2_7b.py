"""qwen2-7b — dense GQA LM with QKV bias [arXiv:2407.10671].

28L, d_model=3584, 28 heads (GQA kv=4, head_dim=128), d_ff=18944,
vocab=152064, QKV bias.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-7b",
        family="dense",
        n_layers=28,
        d_model=3584,
        n_heads=28,
        n_kv_heads=4,
        head_dim=128,
        d_ff=18944,
        vocab_size=152064,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        microbatch=8,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=128,
        qkv_bias=True,
        attn_chunk=64,
    )
