"""The port's blockwise quantize codec against the JAX reference.

The same numpy inputs go through the reference's jitted ``ops.compress`` /
``ops.decompress`` (the Pallas kernel in interpret mode, as the reference's
own tests run it) and through the port's kernel wrappers, which take their
plain PyTorch version for CPU tensors.  Codes, scales and roundtrips must
agree bitwise: the engine's trajectories depend on every code.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compress import transport as jtransport
from repro.kernels import ops as jops
from repro.models import cnn as jcnn
from repro_torch.compress import transport as ttransport
from repro_torch.kernels import ops as tops
from repro_torch.kernels import polyline_codec as tpc
from repro_torch.kernels import ref as tref
from repro_torch.models.convert import params_from_numpy

torch.set_num_threads(1)

#: flat sizes: ragged tails, exact blocks, and CNN leaves (c1_w has 864
#: values, so a (4, 3, 3, 3, 32) stack has blocks that span two clients)
SIZES = [1, 255, 256, 257, 2000, 864, 4 * 864, 4 * 64 + 3]


def _bits_equal(a: np.ndarray, b: np.ndarray) -> bool:
    if a.dtype == np.float32:
        return np.array_equal(a.view(np.uint32), b.view(np.uint32))
    return np.array_equal(a, b)


def _jax_compress(x: np.ndarray, bits: int):
    q, s = jops.compress(jnp.asarray(x), bits)
    return np.asarray(q), np.asarray(s)


def _data(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) * rng.uniform(0.01, 5.0)).astype(np.float32)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("bits", [8, 16])
def test_compress_bitwise_vs_reference(bits, n):
    x = _data(n, seed=n + bits)
    qj, sj = _jax_compress(x, bits)
    qt, st = tops.compress(torch.from_numpy(x), bits)
    nb = math.ceil(n / 256)
    assert qt.shape == (nb, 256) and st.shape == (nb, 1)
    assert qt.dtype == (torch.int8 if bits == 8 else torch.int16)
    assert _bits_equal(qt.numpy(), qj[:nb])
    assert _bits_equal(st.numpy(), sj[:nb])
    # the reference pads to a multiple of 8 blocks (a TPU tiling artefact):
    # those blocks are zero codes at the 1e-30 scale floor
    assert (qj[nb:] == 0).all() and (sj[nb:] == np.float32(1e-30)).all()
    xj = np.asarray(jops.decompress(jnp.asarray(qj), jnp.asarray(sj), (n,)))
    xt = tops.decompress(qt, st, (n,)).numpy()
    assert _bits_equal(xt, xj)


@pytest.mark.parametrize("bits", [8, 16])
def test_exact_ties_round_half_to_even(bits):
    """A block with max|x| = qmax has scale exactly 1 (qmax * fl32(1/qmax)
    rounds to 1), so x = j/2 are exact ties: half to even, not away from
    zero, in both packages."""
    qmax = (1 << (bits - 1)) - 1
    x = ((np.arange(256) - 128) * 0.5).astype(np.float32)
    x[0] = qmax
    qj, sj = _jax_compress(x, bits)
    qt, st = tops.compress(torch.from_numpy(x), bits)
    assert float(st[0, 0]) == 1.0
    assert _bits_equal(qt.numpy(), qj[:1]) and _bits_equal(st.numpy(), sj[:1])
    # -63.5, -63, -62.5, -62, -61.5 -> -64, -63, -62, -62, -62
    assert qt[0, 1:6].tolist() == [-64, -63, -62, -62, -62]


def test_all_zero_block_and_nan_block():
    x = _data(1024, seed=3)
    x[256:512] = 0.0
    x[700] = np.nan
    for bits in (8, 16):
        qj, sj = _jax_compress(x, bits)
        qt, st = tops.compress(torch.from_numpy(x), bits)
        st = st.numpy()[:, 0]
        assert st[1] == np.float32(1e-30) and (qt[1] == 0).all()
        assert np.isnan(st[2]) and np.isnan(sj[2, 0])   # NaN poisons its block
        for b in (0, 1, 3):
            assert _bits_equal(qt[b].numpy(), qj[b])
            assert _bits_equal(st[b:b + 1], sj[b])


def _cnn_params(seed: int, hw: int = 8):
    p = jcnn.cnn_init(jax.random.PRNGKey(seed), in_shape=(hw, hw, 3),
                      n_classes=10)
    return {k: np.asarray(v) for k, v in p.items()}


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("bits", [8, 16])
def test_lossy_bitwise_vs_reference(bits, stacked):
    """The link's lossy step over a whole params dict, as the fused round
    runs it (jitted); stacked = the uplink's (K, ...) client leaves, whose
    blocks straddle clients."""
    p = _cnn_params(seed=bits)
    if stacked:
        p = {k: np.stack([v * (1 + 0.1 * i) for i in range(4)])
             for k, v in p.items()}
    ref_out = jax.jit(jtransport.QuantizeCodec(bits).lossy)(
        {k: jnp.asarray(v) for k, v in p.items()})
    out = ttransport.QuantizeCodec(bits).lossy(params_from_numpy(p, "cpu"))
    assert sorted(out) == sorted(ref_out)
    for k in p:
        assert out[k].shape == p[k].shape
        assert _bits_equal(out[k].numpy(), np.asarray(ref_out[k])), k


def test_stacked_leaf_is_blocked_as_one_tensor():
    """Blocking per client would give other codes: the straddling blocks
    must be those of the flattened (K, ...) leaf."""
    x = np.stack([_data(864, seed=s) * (s + 1) for s in range(4)])
    whole = ttransport.QuantizeCodec(8).lossy([torch.from_numpy(x)])[0]
    per_client = torch.stack([
        ttransport.QuantizeCodec(8).lossy([torch.from_numpy(r)])[0]
        for r in x])
    ref = np.asarray(jax.jit(jtransport.QuantizeCodec(8).lossy)(
        [jnp.asarray(x)])[0])
    assert _bits_equal(whole.numpy(), ref)
    assert not torch.equal(whole, per_client)


@pytest.mark.parametrize("codec", ["none", "polyline:4", "quantize8",
                                   "quantize16"])
@pytest.mark.parametrize("max_elems", [None, 3000])
def test_wire_accounting_matches_reference(codec, max_elems):
    p = _cnn_params(seed=7)
    jc, tc = jtransport.get_codec(codec), ttransport.get_codec(codec)
    tp = params_from_numpy(p, "cpu")
    assert tc.name == jc.name
    assert tc.payload_bytes(tc.marshal(tp)) == jc.payload_bytes(jc.marshal(p))
    assert tc.measure_ratio(tp, max_elems) == jc.measure_ratio(p, max_elems)


def test_codec_registry_grammar_matches_reference():
    assert ttransport.registered_codecs() == jtransport.registered_codecs()
    for spec in ("none", "polyline", "polyline:6", "quantize8",
                 "quantize16", "quantize:4"):
        assert ttransport.get_codec(spec).name == jtransport.get_codec(spec).name
    for bad in ("zstd", "quantize:32", "polyline:x"):
        with pytest.raises(ValueError):
            ttransport.get_codec(bad)


def test_marshal_roundtrip_keeps_shapes():
    tp = params_from_numpy(_cnn_params(seed=1), "cpu")
    for codec in ("none", "polyline:4", "quantize8"):
        c = ttransport.get_codec(codec)
        back = c.unmarshal(c.marshal(tp))
        assert sorted(back) == sorted(tp)
        for k in tp:
            got = torch.as_tensor(np.asarray(back[k]))
            assert tuple(got.shape) == tuple(tp[k].shape)
            assert float((got - tp[k]).abs().max()) < 0.05


def test_wrappers_check_operands():
    with pytest.raises(ValueError):
        tpc.compress_blocks(torch.zeros(4, 256), 8)          # not flat
    with pytest.raises(ValueError):
        tpc.compress_blocks(torch.zeros(10, dtype=torch.float64), 8)
    with pytest.raises(ValueError):
        tpc.compress_blocks(torch.zeros(10), 17)
    with pytest.raises(ValueError):
        tpc.compress_blocks(torch.zeros(10, device="meta"), 8)
    q, s = tpc.compress_blocks(torch.zeros(300), 8)
    with pytest.raises(ValueError):
        tpc.decompress_blocks(q, s, 100)                     # wrong n
    with pytest.raises(ValueError):
        tpc.decompress_blocks(q.to(torch.int32), s, 300)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    tpc.reset_launch_counts()
    x = torch.from_numpy(_data(1000, seed=5))
    q, s = tpc.compress_blocks(x, 8)
    qr, sr = tref.compress_blocks(x, 8)
    assert torch.equal(q, qr) and torch.equal(s, sr)
    tpc.decompress_blocks(q, s, 1000)
    (rt,) = tpc.roundtrip_blocks([x], 8)
    assert _bits_equal(rt.numpy(), tref.roundtrip_blocks([x], 8)[0].numpy())
    assert tpc.launch_counts() == {"compress": 0, "decompress": 0,
                                   "roundtrip": 0}


# --- the fused roundtrip (the links' lossy step) ------------------------------

def _cnn_tree(stacked: bool, seed: int = 0):
    """The paper CNN at full width (CIFAR-10 shape), as the downlink sends
    it or as the uplink's (K=10, ...) client stack."""
    p = _cnn_params(seed=seed, hw=32)
    if stacked:
        p = {k: np.stack([v * (1 + 0.1 * i) for i in range(10)])
             for k, v in p.items()}
    return p


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("bits", [8, 16])
def test_plain_roundtrip_bitwise_vs_reference_lossy(bits, stacked):
    """The roundtrip's plain version over the full-width CNN tree (10
    leaves; 1,225,700 values stacked) is the reference's jitted lossy
    step, bit for bit."""
    p = _cnn_tree(stacked)
    ref_out = jax.jit(jtransport.QuantizeCodec(bits).lossy)(
        {k: jnp.asarray(v) for k, v in p.items()})
    keys = sorted(p)
    outs = tref.roundtrip_blocks(
        [torch.from_numpy(np.array(p[k])).reshape(-1) for k in keys], bits)
    for k, o in zip(keys, outs):
        assert _bits_equal(o.numpy(), np.asarray(ref_out[k]).reshape(-1)), k


SEGMENT_SIZES = [
    [864, 32, 18432, 64, 36864, 64, 65536, 64, 640, 10],   # the CNN's leaves
    [1, 0, 255, 256, 257, 0, 0, 3],                         # tails, empties
    [0, 0],
    [(7 * i) % 300 for i in range(150)],                    # several launches
    [1] * 64 + [5],                                         # 64 then 1
]


@pytest.mark.parametrize("sizes", SEGMENT_SIZES)
def test_segment_table_covers_every_block_once(sizes):
    launches, total = tpc.segment_table(sizes)
    segs = [s for launch in launches for s in launch]
    # every non-empty leaf once, in order; empty leaves get no segment
    assert [s.leaf for s in segs] == [i for i, n in enumerate(sizes) if n]
    assert all(s.n == sizes[s.leaf] for s in segs)
    # at most 64 segments a launch, and a new launch only when one is full
    assert all(1 <= len(l) <= tpc.MAX_SEGMENTS for l in launches)
    assert all(len(l) == tpc.MAX_SEGMENTS for l in launches[:-1])
    for launch in launches:
        # each launch's grid is its leaves' blocks, back to back from 0
        covered = []
        for s in launch:
            covered += [(s.leaf, b) for b in range(-(-s.n // tpc.BLOCK))]
            assert s.first_block == len(covered) - (-(-s.n // tpc.BLOCK))
        assert tpc.launch_blocks(launch) == len(covered)
        assert len(set(covered)) == len(covered)
    # outputs: 256-byte aligned, disjoint, inside the buffer
    assert all(s.offset % tpc.ALIGN == 0 for s in segs)
    ends = [(s.offset, s.offset + s.n) for s in segs]
    assert all(a[1] <= b[0] for a, b in zip(ends, ends[1:]))
    last = segs[-1] if segs else None
    assert total == (last.offset + -(-last.n // tpc.ALIGN) * tpc.ALIGN
                     if last else 0)


def test_roundtrip_wrapper_checks_operands():
    ok = torch.zeros(300)
    for bad in ([torch.zeros(4, 256)],                       # not flat
                [ok, torch.zeros(10, dtype=torch.float64)],  # not float32
                [torch.zeros(600)[::2]],                     # not contiguous
                [ok, torch.zeros(10, device="meta")]):       # not cpu/cuda
        with pytest.raises(ValueError):
            tpc.roundtrip_blocks(bad, 8)
    for bits in (1, 17):
        with pytest.raises(ValueError):
            tpc.roundtrip_blocks([ok], bits)
    assert tpc.roundtrip_blocks([], 8) == []


def test_lossy_keeps_shapes_dtypes_and_its_input():
    rng = np.random.default_rng(11)
    tree = {"a": torch.from_numpy(rng.standard_normal((3, 5, 7))
                                  .astype(np.float32)),
            "b": torch.from_numpy(rng.standard_normal(300)
                                  .astype(np.float32)).to(torch.bfloat16),
            "c": torch.zeros((0, 4)),
            "d": torch.from_numpy(rng.standard_normal((2, 129))),   # f64
            "e": torch.from_numpy(rng.standard_normal((17,))
                                  .astype(np.float32))[None]}
    before = {k: v.clone() for k, v in tree.items()}
    out = ttransport.QuantizeCodec(8).lossy(tree)
    assert sorted(out) == sorted(tree)
    for k, v in tree.items():
        assert out[k].shape == v.shape and out[k].dtype == v.dtype, k
        assert torch.equal(v, before[k]), k           # input left as it was
        want = tref.roundtrip_blocks([v.reshape(-1).float()], 8)[0]
        assert torch.equal(out[k], want.reshape(v.shape).to(v.dtype)), k
    assert not torch.equal(out["a"], tree["a"])       # it is lossy


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 16])
def test_cuda_kernel_matches_plain_version(bits):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    tpc.reset_launch_counts()
    for n in (1, 255, 257, 2000, 10 * 65600):
        x = torch.randn(n, device="cuda") * 0.05
        q, s = tpc.compress_blocks(x, bits)
        qr, sr = tref.compress_blocks(x, bits)
        assert torch.equal(q, qr)
        assert torch.equal(s.view(torch.int32), sr.view(torch.int32))
        xr = tpc.decompress_blocks(q, s, n)
        xrr = tref.decompress_blocks(qr, sr, n)
        assert torch.equal(xr.view(torch.int32), xrr.view(torch.int32))
    assert tpc.launch_counts() == {"compress": 5, "decompress": 5,
                                   "roundtrip": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 16])
def test_cuda_roundtrip_matches_pair_and_plain(bits):
    """The fused roundtrip against the kernel pair, leaf by leaf, and the
    plain version: tails, a leaf at an offset that is not 16-byte aligned
    (the scalar path), an empty leaf, and 150 leaves (3 launches)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(bits)
    big = torch.randn(5000, device="cuda", generator=g)
    leaves = [torch.randn(n, device="cuda", generator=g)
              for n in (1, 255, 257, 2000, 10 * 65600, 0)] + [big[1:4001]]
    leaves += [torch.randn(1 + (37 * i) % 700, device="cuda", generator=g)
               for i in range(143)]
    tpc.reset_launch_counts()
    outs = tpc.roundtrip_blocks(leaves, bits)
    assert tpc.launch_counts()["roundtrip"] == 3
    plain = tref.roundtrip_blocks(leaves, bits)
    for x, o, p in zip(leaves, outs, plain):
        pair = tpc.decompress_blocks(*tpc.compress_blocks(x, bits), x.numel())
        assert torch.equal(o.view(torch.int32), pair.view(torch.int32))
        assert torch.equal(o.view(torch.int32), p.view(torch.int32))
