"""Tiny dense causal LMs: the federated ``tiny_lm`` entry + example scales.

:func:`dense_lm` is the one place a plain dense-LM :class:`ModelConfig`
is assembled from a (d_model, n_layers) budget — the pretrain example and
any future entry point size their models through it instead of hand-writing
configs.  ``config()``/``smoke()`` expose the CPU-sized variant the
federated model registry (``models/registry.py`` ``tiny_lm``) binds; it
is registered as arch id ``tiny-lm`` so ``--arch tiny-lm`` works in every
entry point that resolves through ``configs/registry.py``.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig


def dense_lm(d_model: int, n_layers: int, vocab_size: int = None,
             **kw) -> ModelConfig:
    """A dense decoder sized from (d_model, n_layers); heads are d/64
    (head_dim 64) with GQA when 4 divides them, ff ~ 8/3 d rounded to 64."""
    heads = max(d_model // 64, 1)
    kv = 4 if heads % 4 == 0 else heads
    if vocab_size is None:
        vocab_size = 32000 if d_model >= 768 else 8192
    return ModelConfig(
        name=f"lm-{n_layers}x{d_model}", family="dense",
        n_layers=n_layers, d_model=d_model, n_heads=heads, n_kv_heads=kv,
        head_dim=64, d_ff=max(int(d_model * 8 / 3) // 64 * 64, 64),
        vocab_size=vocab_size, attn_chunk=256, **kw)


def config() -> ModelConfig:
    """The federated tiny LM: small enough that the vmapped per-client
    update stays CPU-cheap at simulation scale (remat off: the fused
    round step re-runs it per event, activations are tiny)."""
    return ModelConfig(
        name="tiny-lm", family="dense", n_layers=1, d_model=32,
        n_heads=2, n_kv_heads=2, head_dim=16, d_ff=96, vocab_size=64,
        attn_chunk=64, remat=False)


def long() -> ModelConfig:
    """The long-sequence federated tiny LM (arch id ``tiny-lm-long``):
    same weights-shape as ``tiny-lm`` but tuned for seq_len ~128, where
    the O(S^2) attention term dominates the step — this is the config the
    engine_lm flash-vs-reference bench rows run (benchmarks/run.py).
    ``attn_chunk=32`` keeps both backends on their chunked paths so the
    comparison is streaming-vs-streaming, not streaming-vs-materialized.
    """
    return config().replace(name="tiny-lm-long", attn_chunk=32)


def smoke() -> ModelConfig:
    return config()
