"""numpy models of the kernels' TF32 tensor-core products, shared by the
tests of the 3xTF32 designs (the chunk scans, csrc/chunk_scan.cuh, and
the fp32 flash-attention backward, csrc/flash_attention_bwd.cu)."""
import numpy as np


def tf32(x, mode):
    """float32 ``x`` cut to TF32's 10 mantissa bits: "rna" rounds to
    nearest, ties away (the kernels' hi), "trunc" drops the bits (what the
    tensor cores do with the bits of an operand past TF32's)."""
    b = np.asarray(x, np.float32).view(np.uint32)
    if mode == "rna":
        b = b + np.uint32(0x1000)
    return (b & np.uint32(0xFFFFE000)).view(np.float32)


def mma(a, b, split):
    """a @ b as the tensor cores take it in f32 accumulation: "tf32" one
    product of TF32 operands; "3xtf32" the kernels' split, hi = tf32(x),
    lo = x - hi (read truncated), lo_a hi_b + hi_a lo_b + hi_a hi_b.
    Batched like ``np.matmul``; returns float64."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    if split == "tf32":
        return tf32(a, "rna").astype(np.float64) @ tf32(b, "rna")
    ah, bh = tf32(a, "rna"), tf32(b, "rna")
    al, bl = tf32(a - ah, "trunc"), tf32(b - bh, "trunc")
    f = lambda x: x.astype(np.float64)  # noqa: E731
    return f(al) @ f(bh) + f(ah) @ f(bl) + f(ah) @ f(bh)
