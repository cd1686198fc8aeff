"""h2o-danube-3-4b — llama+mistral-style dense LM with sliding-window attention
[arXiv:2401.16818].

24L, d_model=3840, 32 heads (GQA kv=8, head_dim=120), d_ff=10240, vocab=32000,
SWA window 4096 (mistral-style).
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-3-4b",
        family="dense",
        n_layers=24,
        d_model=3840,
        n_heads=32,
        n_kv_heads=8,
        head_dim=120,         # 3840 / 32
        d_ff=10240,
        vocab_size=32000,
        swa_window=4096,
        microbatch=8,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=128,
        swa_window=64,
        attn_chunk=64,
    )
