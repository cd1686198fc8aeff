"""minitron-8b — width-pruned Nemotron-4 dense LM [arXiv:2407.14679].

32L, d_model=4096, 32 heads (GQA kv=8, head_dim=128), d_ff=16384,
vocab=256000.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="minitron-8b",
        family="dense",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=16384,
        vocab_size=256000,
        microbatch=8,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="minitron-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=128,
        attn_chunk=64,
    )
