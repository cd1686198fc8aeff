"""qwen1.5-110b — large dense GQA LM with QKV bias [hf:Qwen/Qwen1.5-110B].

80L, d_model=8192, 64 heads (GQA kv=8, head_dim=128), d_ff=49152,
vocab=152064, QKV bias.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-110b",
        family="dense",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=49152,
        vocab_size=152064,
        qkv_bias=True,
        microbatch=16,  # grad accumulation: 110B activations need microbatching
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-smoke",
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
