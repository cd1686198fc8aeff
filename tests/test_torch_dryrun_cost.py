"""The dry-run's FLOPs and collectives (launch/dryrun.py ``cell_costs``),
and the kernels' entry points on ``meta`` tensors (kernels/meta.py).

* FLOPs: a train step of small cells (2 layers, narrow widths: a dense,
  a moe, the rwkv6 and the zamba2 family) counted on meta tensors
  (``dryrun.step_flops``) equals a hand count of its products: every
  matmul 2 m n k forward and again for each operand that needs a
  gradient, attention 4 hd a visible (query, key) pair and head forward
  and 10 hd backward, the chunk scans in their chunked form at the
  kernels' chunk, and the forward of every checkpointed layer again in
  its recompute, up to the layer's last product: torch's checkpoint stops
  the recompute once it has rebuilt every tensor the backward saved
  (``set_checkpoint_early_stop``, on by default), and a layer that ends
  in ``x + h @ w_out`` saved that matmul's inputs, not its output (rwkv6's
  channel mix ends in a product of two saved tensors, so its recompute
  is whole).
  The reference's ``cost_analysis()`` of the same loss and gradient,
  compiled by XLA on one CPU device with the layers unrolled
  (``scan_layers=False``, so no remat either), is at least the port's
  count of the same: XLA also counts elementwise ops.  Read on the CPU
  for qwen2-7b's smoke config at 2 x 128 tokens: the port 155,418,624,
  XLA 171,393,616 (ratio 0.907).  With the layers scanned XLA counts the
  loop's body once (runtime/hlo.py says as much of its collectives) and
  reads 114,294,888 against the port's 193,232,896 with remat, so that
  configuration is not a comparison.
* Collectives: on gloo ranks (``launch/mesh.py`` ``run_ranks``), one
  train step of tests/test_torch_fsdp.py's configuration (qwen2-7b smoke
  at microbatch 2 on 2 and 4 data ranks; each layer loop at microbatch 1
  on 2) and of the multi-pod step on (pod=2, data=2) moves ``FSDP.stats``
  by exactly ``steps.collective_plan``'s gathers and reduce-scatters,
  counts and buffer bytes (the plan the dry-run reports), and every
  ``all_reduce`` and ``broadcast`` the step calls is one of the plan's,
  byte for byte, once gloo's spelling of the two FSDP collectives is
  taken out (an all-gather is D broadcasts of a shard, a reduce-scatter
  an all_reduce of the whole buffer).
* The command line: every applicable cell of the recurrent families
  carries ``cost.flops`` (the total over the mesh's devices) and, for a
  train cell, its collectives; a serving cell says it runs none.
* Meta tensors: ``wkv6``, ``ssd_scan`` and ``ops.attention`` take them
  through their plain versions (kernels/ref.py's meta ops), gradients
  included, and a CUDA-typed call (fake CUDA tensors) launches the
  kernel and never reaches a plain version.
"""
import json
import os
import pickle
import textwrap
import types

import jax
import jax.numpy as jnp
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import TrainConfig
from repro_torch.configs.registry import get_smoke_config
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.core import steps
from repro_torch.kernels import flash_attention, ops, ref, rwkv6_scan, ssd
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import rwkv6, zamba2

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ("qwen2-7b", "granite-moe-3b-a800m", "hubert-xlarge",
            "rwkv6-3b", "zamba2-2.7b")


# ---------------------------------------------------------------------------
# FLOPs: the hand count
# ---------------------------------------------------------------------------

def _mm(m, k, n):
    return 2 * m * k * n


def _train(gemms, fwd_kernels, bwd_kernels, remat_fwd):
    """A train step: each matmul (flops, operands needing a gradient)
    forward once and again per such operand; the kernels' forward and
    backward products; ``remat_fwd`` the forward the checkpointed layers
    recompute."""
    return (sum(f * (1 + g) for f, g in gemms) + fwd_kernels + bwd_kernels
            + remat_fwd)


def _attention_layer(cfg, B, S):
    """(matmul list, forward products, backward products) of one
    attention block at full sequence."""
    T, d, hd = B * S, cfg.d_model, cfg.head_dim
    H, kv = cfg.n_heads, cfg.n_kv_heads
    gemms = [(_mm(T, d, H * hd), 2), (_mm(T, d, kv * hd), 2),
             (_mm(T, d, kv * hd), 2), (_mm(T, H * hd, d), 2)]
    pairs = S * (S + 1) // 2
    return gemms, 4 * B * H * pairs * hd, 10 * B * H * pairs * hd


def _swiglu(T, d, ff):
    return [(_mm(T, d, ff), 2), (_mm(T, d, ff), 2), (_mm(T, ff, d), 2)]


def _fwd(gemms):
    return sum(f for f, _ in gemms)


def _recompute(layer):
    """A checkpointed layer's recompute: its forward but its last matmul
    (the module docstring's early stop)."""
    return _fwd(layer[:-1])


def hand_dense(cfg, B, S):
    T = B * S
    att, af, ab = _attention_layer(cfg, B, S)
    layer = att + _swiglu(T, cfg.d_model, cfg.d_ff)
    head = [(_mm(T, cfg.d_model, cfg.vocab_size), 2)]
    L = cfg.n_layers
    return _train(layer * L + head, L * af, L * ab,
                  L * (_recompute(layer) + af))


def hand_moe(cfg, B, S):
    """256-token routing groups (n = B, g = S / 256, G = 256) with
    capacity C: the router, the dense dispatch (its one-hot operand needs
    no gradient), the experts' SwiGLU over the E x C slots and the
    combine."""
    T, d, m = B * S, cfg.d_model, cfg.moe
    G, E, ff = 256, m.n_experts, m.expert_d_ff
    C = max(int(m.capacity_factor * m.top_k * G / E), 1)
    slots = (T // G) * E * C
    att, af, ab = _attention_layer(cfg, B, S)
    layer = att + [(_mm(T, d, E), 2), (_mm(T, E * C, d), 1),
                   (_mm(slots, d, ff), 2), (_mm(slots, d, ff), 2),
                   (_mm(slots, ff, d), 2), (_mm(T, E * C, d), 2)]
    head = [(_mm(T, d, cfg.vocab_size), 2)]     # the tied embedding
    L = cfg.n_layers
    return _train(layer * L + head, L * af, L * ab,
                  L * (_recompute(layer) + af))


def hand_rwkv6(cfg, B, S):
    """Time-mix: the ddlerp LoRA (d -> 5 m, then 5 (m -> d)), r/k/v/g,
    the decay LoRA (d -> m_w -> da), the output; WKV6 over H heads of N;
    channel-mix: k, v, r (the layer ends in r * v: recomputed whole)."""
    T, d, r = B * S, cfg.d_model, cfg.rwkv
    N = r.head_size
    H = rwkv6.padded_rwkv_heads(cfg, 1)
    da = H * N
    layer = ([(_mm(T, d, 5 * r.mix_lora), 2), (5 * _mm(T, r.mix_lora, d), 2)]
             + [(_mm(T, d, da), 2)] * 4
             + [(_mm(T, d, r.decay_lora), 2), (_mm(T, r.decay_lora, da), 2),
                (_mm(T, da, d), 2), (_mm(T, d, cfg.d_ff), 2),
                (_mm(T, cfg.d_ff, d), 2), (_mm(T, d, d), 2)])
    wf = rwkv6_scan.flops(B, S, H, N)
    wb = rwkv6_scan.bwd_flops(B, S, H, N)
    head = [(_mm(T, d, cfg.vocab_size), 2)]
    L = cfg.n_layers
    return _train(layer * L + head, L * wf, L * wb, L * (_fwd(layer) + wf))


def hand_zamba2(cfg, B, S):
    """Mamba2 layers (z, x, B, C, dt in, out; the SSD scan; the causal
    conv is elementwise), checkpointed; the shared attention + SwiGLU
    block once every ``attn_every`` layers, not checkpointed."""
    T, d, s = B * S, cfg.d_model, cfg.ssm
    di, nh = s.d_inner(d), s.n_heads(d)
    layer = [(_mm(T, d, di), 2), (_mm(T, d, di), 2), (_mm(T, d, s.d_state), 2),
             (_mm(T, d, s.d_state), 2), (_mm(T, d, nh), 2),
             (_mm(T, di, d), 2)]
    sf = ssd.flops(B, S, nh, s.head_dim, s.d_state)
    sb = ssd.bwd_flops(B, S, nh, s.head_dim, s.d_state)
    att, af, ab = _attention_layer(cfg, B, S)
    shared = att + _swiglu(T, d, cfg.d_ff)
    apps = zamba2.n_attn_apps(cfg)
    L = apps * cfg.attn_every
    head = [(_mm(T, d, cfg.vocab_size), 2)]
    return _train(layer * L + shared * apps + head, L * sf + apps * af,
                  L * sb + apps * ab, L * (_recompute(layer) + sf))


HAND = {"qwen2-7b": (hand_dense, 128), "granite-moe-3b-a800m": (hand_moe, 256),
        "rwkv6-3b": (hand_rwkv6, 128), "zamba2-2.7b": (hand_zamba2, 128)}


@pytest.mark.parametrize("arch", sorted(HAND))
def test_train_flops_equal_the_hand_count(arch):
    hand, S = HAND[arch]
    cfg = get_smoke_config(arch)
    B = 2
    by_op = dryrun.step_flops(cfg, ShapeConfig("s", S, B, "train"))
    assert sum(by_op.values()) == hand(cfg, B, S), by_op
    # the kernels are counted by their formulas, not their plain versions
    kernels = {"qwen2-7b": "attention", "granite-moe-3b-a800m": "attention",
               "rwkv6-3b": "wkv6", "zamba2-2.7b": "ssd"}[arch]
    assert f"repro_torch.{kernels}" in by_op
    assert f"repro_torch.{kernels}_backward" in by_op


def test_flops_at_most_the_reference_cost_analysis():
    """qwen2-7b's smoke config, 2 x 128 tokens, layers unrolled: the
    reference's loss and gradient compiled by XLA on one CPU device count
    at least what the port counts (module docstring: the ratio)."""
    from repro.configs import registry as jregistry
    from repro.models import lm as jlm
    cfg = jregistry.get_smoke_config("qwen2-7b").replace(scan_layers=False)
    B, S = 2, 128
    params = jlm.init_params(cfg, jax.random.PRNGKey(0), 1)
    batch = {"tokens": jnp.zeros((B, S), jnp.int32)}

    def loss(p):
        return jlm.loss_fn(cfg, p, batch, 1)[0]
    compiled = jax.jit(jax.value_and_grad(loss)).lower(params).compile()
    cost = compiled.cost_analysis()
    cost = cost[0] if isinstance(cost, (list, tuple)) else cost
    ref_flops = float(cost["flops"])
    port = sum(dryrun.step_flops(
        get_smoke_config("qwen2-7b").replace(scan_layers=False),
        ShapeConfig("s", S, B, "train")).values())
    assert 0 < port <= ref_flops, (port, ref_flops)


def test_cell_costs_divide_the_step_over_the_devices():
    single = dryrun.cell_costs("qwen2-7b", "train_4k", False)
    multi = dryrun.cell_costs("qwen2-7b", "train_4k", True)
    total = single["cost"]["flops_total"]
    assert total == multi["cost"]["flops_total"] == sum(
        single["cost"]["flops_by_op"].values())
    assert single["cost"]["flops"] == total / 256
    assert multi["cost"]["flops"] == total / 512
    # a multi-pod step adds the pod exchange and the pods' metrics
    assert single["collectives"]["all-gather"] == \
        multi["collectives"]["all-gather"] > 0
    assert "broadcast" not in single["collectives"]
    assert multi["collectives"]["broadcast"] == 2 * 2
    assert multi["collective_bytes_per_device"] > \
        single["collective_bytes_per_device"] > 0
    serve = dryrun.cell_costs("qwen2-7b", "decode_32k", False)
    assert serve["collectives"] is None and "no collective" in \
        serve["collectives_note"]
    assert serve["cost"]["flops"] > 0


@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-2.7b"])
def test_command_line_counts_every_cell(tmp_path, arch):
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", arch, "--shape", "all", "--mesh", "both",
                     "--out", str(tmp_path)])
    assert e.value.code == 0
    n = 0
    for tag, devices in (("single", 256), ("multi", 512)):
        with open(tmp_path / f"dryrun_{tag}.json") as f:
            cells = [c for c in json.load(f) if not c.get("skipped")]
        for c in cells:
            n += 1
            assert c["cost"]["flops"] == c["cost"]["flops_total"] / devices
            assert c["cost"]["flops"] > 0 and "bytes_accessed" not in \
                c["cost"]
            if c["shape"] == "train_4k":
                assert c["collectives"]["all-gather"] > 0
                assert c["collective_bytes_per_device"] > 0
            else:
                assert c["collectives"] is None
    assert n == 8      # 4 shapes (long_500k included) on both meshes


# ---------------------------------------------------------------------------
# collectives: the plan against the ranks' counters
# ---------------------------------------------------------------------------

_RANK = textwrap.dedent("""
    import pickle, sys
    import numpy as np, torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch.configs import TrainConfig
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.core import steps
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.runtime import sharding as shd

    mesh_mod.init_from_env(torch.device("cpu"))
    out_path = sys.argv[1].format(mesh_mod.rank())
    families = [a for a in sys.argv[2].split(",") if a]
    D = mesh_mod.world_size()
    calls = []
    real = {n: getattr(dist, n) for n in ("all_reduce", "broadcast")}

    def wrap(name):
        def call(t, *a, **k):
            calls.append((name, t.numel() * t.element_size()))
            return real[name](t, *a, **k)
        return call

    def step(fns, batch, fsdp):
        state = fns.init_state(0)
        before = dict(fsdp.stats)
        calls.clear()
        for n in real:
            setattr(dist, n, wrap(n))
        try:
            fns.train_step(state, batch)
        finally:
            for n, f in real.items():
                setattr(dist, n, f)
        return {"stats": {k: fsdp.stats[k] - before[k] for k in before},
                "calls": sorted(calls)}

    out = {}
    mesh = mesh_mod.make_mesh((D, 1), ("data", "model"))
    fsdp = shd.FSDP.over(mesh)
    tok = np.random.default_rng(0).integers(0, 128, (8, 64)).astype(np.int32)
    cfg = get_smoke_config("qwen2-7b").replace(microbatch=2)
    fns = steps.make_single_pod_step(
        cfg, TrainConfig(lr=1e-3, warmup_steps=2, total_steps=10), mesh,
        device="cpu")
    out["qwen2-7b/mb2"] = step(fns, {"tokens": tok}, fsdp)
    for arch in families:
        fcfg = get_smoke_config(arch).replace(microbatch=1)
        fns = steps.make_single_pod_step(fcfg, TrainConfig(lr=1e-3), mesh,
                                         device="cpu")
        batch = TokenPipeline(fcfg, ShapeConfig("s", 64, 4, "train"),
                              seed=0).batch(0)
        out[arch] = step(fns, batch, fsdp)
    if D == 4:
        pmesh = mesh_mod.make_mesh((2, 2, 1), ("pod", "data", "model"))
        tcfg = TrainConfig(lr=1e-3, fedat_enabled=True, fedat_sync_every=1,
                           fedat_compress_bits=8)
        fns = steps.make_fedat_step(cfg, tcfg, pmesh, device="cpu")
        batch = steps.split_batch_for_pods({"tokens": tok}, 2)
        out["multipod"] = step(fns, batch, shd.FSDP.over(pmesh))
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
    mesh_mod.shutdown()
""")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("collectives")
    out = {}
    for D, fam in ((2, ",".join(FAMILIES)), (4, "")):
        store = d / f"store{D}"
        store.mkdir()
        res = mesh_mod.run_ranks(
            ["-c", _RANK, str(d / f"d{D}_rank{{}}.pkl"), fam], D,
            timeout=600, store_dir=str(store),
            env={"PYTHONPATH": os.path.join(REPO, "src"),
                 "OMP_NUM_THREADS": "1"})
        assert all(rc == 0 for rc, _, _ in res), [e[-3000:] for *_, e in res]
        out[D] = []
        for r in range(D):
            with open(d / f"d{D}_rank{r}.pkl", "rb") as f:
                out[D].append(pickle.load(f))
    return out


def _mesh(**shape):
    return mesh_mod.Mesh(tuple(shape.values()), tuple(shape), runnable=False)


def _gloo_calls(plan, mesh):
    """The ``all_reduce`` and ``broadcast`` calls a gloo rank makes for
    ``plan``: an all-gather is one broadcast of a shard from each of the
    D ranks, a reduce-scatter an all_reduce of the whole fp32 buffer."""
    D = mesh.shape["data"]
    out = []
    for op, _, n, nbytes in plan:
        if op == "all-gather":
            out += [("broadcast", nbytes // D)] * (n * D)
        elif op == "reduce-scatter":
            out += [("all_reduce", nbytes)] * n
        else:
            out += [(op.replace("-", "_"), nbytes)] * n
    return sorted(out)


@pytest.mark.parametrize("D,case", [(2, "qwen2-7b/mb2"), (4, "qwen2-7b/mb2"),
                                    (4, "multipod")]
                         + [(2, a) for a in FAMILIES])
def test_plan_equals_the_ranks_collectives(ranks, D, case):
    multi = case == "multipod"
    arch, mb = ("qwen2-7b", 2) if multi or case.endswith("/mb2") \
        else (case, 1)
    cfg = get_smoke_config(arch).replace(microbatch=mb)
    if multi:
        mesh = _mesh(pod=2, data=2, model=1)
        tcfg = TrainConfig(lr=1e-3, fedat_enabled=True, fedat_sync_every=1,
                           fedat_compress_bits=8)
    else:
        mesh = _mesh(data=D, model=1)
        tcfg = TrainConfig(lr=1e-3)
    plan = steps.collective_plan(cfg, tcfg, mesh, multi)
    want = steps.fsdp_stats(plan)
    assert want["gathers"] > 0 and want["reduce_scatters"] > 0
    for info in ranks[D]:
        got = info[case]
        assert got["stats"] == want
        assert got["calls"] == _gloo_calls(plan, mesh)
    if arch == "qwen2-7b":
        # 2L + 2 gathers and L + 2 reduce-scatters a microbatch under remat
        L = cfg.n_layers
        assert want["gathers"] == mb * (2 * L + 2)
        assert want["reduce_scatters"] == mb * (L + 2)


# ---------------------------------------------------------------------------
# meta tensors
# ---------------------------------------------------------------------------

def _meta(*shape, grad=False):
    return torch.empty(shape, device="meta", requires_grad=grad)


def test_scans_and_attention_take_meta_tensors():
    B, S, H, N, P = 2, 70, 3, 8, 4
    r, k, v = (_meta(B, S, H, N, grad=True) for _ in range(3))
    logw, u = _meta(B, S, H, N, grad=True), _meta(H, N, grad=True)
    y, st = rwkv6_scan.WKV6.apply(r, k, v, logw, u, torch.zeros(
        (B, H, N, N), device="meta"), 32)
    assert y.device.type == "meta" and y.shape == (B, S, H, N)
    grads = torch.autograd.grad(y.sum(), (r, k, v, logw, u))
    assert [g.shape for g in grads] == [t.shape for t in (r, k, v, logw, u)]
    state = torch.zeros((B, H, N, N), device="meta")
    assert rwkv6_scan.wkv6(r.detach(), k.detach(), v.detach(),
                           logw.detach(), u.detach(), state).shape == \
        (B, S, H, N)
    x, Bm, Cm = _meta(B, S, H, P, grad=True), _meta(B, S, N, grad=True), \
        _meta(B, S, N, grad=True)
    da = _meta(B, S, H, grad=True)
    y, h = ssd.SSDScan.apply(x, Bm, Cm, da, torch.zeros(
        (B, H, P, N), device="meta"), 32)
    assert y.shape == (B, S, H, P) and h.shape == (B, H, P, N)
    grads = torch.autograd.grad(y.sum(), (x, Bm, Cm, da))
    assert [g.shape for g in grads] == [t.shape for t in (x, Bm, Cm, da)]
    q = _meta(B, S, 4, 16, grad=True)
    kk, vv = _meta(B, S, 2, 16, grad=True), _meta(B, S, 2, 16, grad=True)
    for impl in ("auto", "kernel", "blocked"):
        o = ops.attention(q, kk, vv, causal=True, window=16, impl=impl)
        assert o.device.type == "meta" and o.shape == q.shape
    g = torch.autograd.grad(ops.attention(q, kk, vv, prefix_len=8).sum(),
                            (q, kk, vv))
    assert [t.shape for t in g] == [q.shape, kk.shape, vv.shape]


def test_prefix_backward_is_the_gradient_of_the_prefix_forward():
    """The plain backward's prefix-LM mask (the meta route's): against
    autograd of the blocked forward on the CPU."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 40, 4, 8, generator=g, requires_grad=True)
    k = torch.randn(2, 40, 2, 8, generator=g, requires_grad=True)
    v = torch.randn(2, 40, 2, 8, generator=g, requires_grad=True)
    dout = torch.randn(2, 40, 4, 8, generator=g)
    out, lse = ref.blocked_attention(q, k, v, causal=True, prefix_len=12,
                                     block=16, return_lse=True)
    want = torch.autograd.grad(out, (q, k, v), dout)
    got = ref.blocked_attention_backward(q.detach(), k.detach(), v.detach(),
                                         out.detach(), lse, dout,
                                         causal=True, block=16,
                                         prefix_len=12)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_meta_counts_the_visible_pairs():
    pairs = flash_attention.visible_pairs
    assert pairs(8, 8, True, None) == 36
    assert pairs(8, 8, True, 3) == 1 + 2 + 3 * 6
    assert pairs(8, 8, True, None, prefix_len=4) == 36 + (3 + 2 + 1)
    assert pairs(8, 8, False, None) == 64
    from torch.utils.flop_counter import FlopCounterMode
    q, k = _meta(1, 8, 2, 4), _meta(1, 8, 2, 4)
    with FlopCounterMode(display=False,
                         custom_mapping=dryrun.FLOP_FORMULAS) as fc:
        ops.attention(q, k, k, causal=True)
    assert fc.get_total_flops() == 4 * 2 * 36 * 4


class _Launched(Exception):
    pass


@pytest.fixture
def fake_cuda(monkeypatch):
    """CUDA-typed tensors without a card: the launch raises _Launched, and
    every plain version (the meta ops' too) fails the test if reached."""
    def launched(*a, **k):
        raise _Launched()

    def plain(*a, **k):
        raise AssertionError("a CUDA tensor reached a plain version")
    for lib in (rwkv6_scan._LIB, ssd._LIB, flash_attention._LIB):
        monkeypatch.setattr(lib, "launch", launched)
    for mod, names in ((ref, ("wkv6_chunked", "ssd_chunked",
                              "blocked_attention")),
                       (ops, ("blocked_attention",))):
        for n in names:
            monkeypatch.setattr(mod, n, plain)
    monkeypatch.setattr(torch.cuda, "device", lambda d: _NullContext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))
    with FakeTensorMode(allow_non_fake_inputs=True):
        yield


class _NullContext:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


@pytest.mark.filterwarnings("ignore:Accessing the data pointer")
def test_cuda_tensors_launch_the_kernels_never_the_plain_version(fake_cuda):
    B, S, H, N = 1, 64, 2, 16
    cuda = dict(device="cuda")
    r = torch.empty((B, S, H, N), **cuda)
    with pytest.raises(_Launched):
        rwkv6_scan.wkv6(r, r, r, r, torch.empty((H, N), **cuda),
                        torch.zeros((B, H, N, N), **cuda))
    x, Bm = torch.empty((B, S, H, N), **cuda), torch.empty((B, S, N), **cuda)
    with pytest.raises(_Launched):
        ssd.ssd_scan(x, Bm, Bm, torch.empty((B, S, H), **cuda),
                     torch.zeros((B, H, N, N), **cuda))
    q = torch.empty((B, S, 4, 16), **cuda)
    kv = torch.empty((B, S, 2, 16), **cuda)
    with pytest.raises(_Launched):
        ops.attention(q, kv, kv, causal=True)
