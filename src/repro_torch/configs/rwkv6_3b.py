"""rwkv6-3b (Finch) — attention-free RNN with data-dependent decay
[arXiv:2404.05892].

32L, d_model=2560 (40 heads of size 64), channel-mix d_ff=8960, vocab=65536.
"""
from repro_torch.configs.base import ModelConfig, RWKVConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b",
        family="ssm",
        n_layers=32,
        d_model=2560,
        n_heads=40,            # d_model / head_size
        n_kv_heads=40,
        head_dim=64,
        d_ff=8960,
        vocab_size=65536,
        rwkv=RWKVConfig(head_size=64, decay_lora=64, mix_lora=32),
        microbatch=8,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-smoke",
        family="ssm",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=128,
        rwkv=RWKVConfig(head_size=16, decay_lora=8, mix_lora=8),
        attn_chunk=64,
    )
