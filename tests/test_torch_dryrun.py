"""The dry-run (launch/dryrun.py) and tensor parallelism > 1 against the
JAX reference.

* The cell list: every (arch x shape x mesh) cell the reference's
  ``configs.applicable`` keeps is counted, every other one is skipped.
* Per-device bytes of qwen2-7b and deepseek-moe-16b ``train_4k`` on both
  production meshes equal the reference's abstract shapes
  (``lm.abstract_params`` bf16, AdamW m/v fp32, ``lm.input_specs``)
  divided, dimension by dimension, by the shard factors of the
  reference's own ``_resolve``; the serve cells' cache the same way from
  ``lm.abstract_cache`` and ``lm.cache_axes_tree``; the multi-pod
  cells' cross-pod payload from each leaf's quantized shape.
* ``param_specs(tp=2)`` shapes equal the reference's for every family,
  and the smoke loss at tp = 2 (padded heads and vocab, the ``reference``
  attention backend) against the reference's single-device tp = 2 loss
  from the same params, fp32, within ``TP_LOSS_RTOL`` relative (fp32
  sums in another order; measured on the CPU: 9.8e-8 qwen2, 9.8e-8
  rwkv6, 1.9e-7 deepseek-moe).
"""
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JSHAPES
from repro.configs import applicable as japplicable
from repro.configs import registry as jregistry
from repro.configs.registry import get_smoke_config as jsmoke
from repro.models import lm as jlm
from repro.runtime import sharding as jshd
from repro_torch.configs.registry import get_smoke_config as tsmoke
from repro_torch.launch import dryrun
from repro_torch.models import lm as tlm
from repro_torch.models.common import flatten_tree
from repro_torch.models.convert import params_from_numpy

torch.set_num_threads(1)

MESHES = {False: {"data": 16, "model": 16},
          True: {"pod": 2, "data": 16, "model": 16}}
TP_LOSS_RTOL = 2e-6


def test_cell_list_matches_reference():
    want, got = set(), set()
    for multi in (False, True):
        for arch in jregistry.ARCH_IDS:
            for shape in JSHAPES:
                if japplicable(jregistry.get_config(arch), JSHAPES[shape]):
                    want.add((arch, shape, multi))
                r = dryrun.compile_cell(arch, shape, multi)
                if not r.get("skipped"):
                    assert r["peak_bytes_per_device"] > 0
                    assert r["n_devices"] == (512 if multi else 256)
                    got.add((arch, shape, multi))
    assert got == want and len(want) == 76


def _ref_bytes(tree, axes, shape, rules):
    """The reference's per-device bytes of a tree of ShapeDtypeStructs."""
    duck = types.SimpleNamespace(shape=dict(shape))
    leaves = jax.tree.leaves(tree)
    ax = jax.tree.leaves(axes, is_leaf=lambda t: isinstance(t, tuple) and
                         all(a is None or isinstance(a, str) for a in t))
    assert len(leaves) == len(ax)
    total = 0
    for leaf, a in zip(leaves, ax):
        spec = tuple(jshd._resolve(a, duck, rules))
        n = 1
        for d, s in zip(leaf.shape, spec + (None,) * len(leaf.shape)):
            k = 1 if s is None else math.prod(
                duck.shape[x] for x in (s if isinstance(s, tuple) else (s,)))
            n *= -(-d // k)
        total += n * jnp.dtype(leaf.dtype).itemsize
    return total


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("arch,shape", [
    ("qwen2-7b", "train_4k"), ("deepseek-moe-16b", "train_4k"),
    ("qwen2-7b", "decode_32k"), ("rwkv6-3b", "long_500k"),
    ("zamba2-2.7b", "prefill_32k")])
def test_device_bytes_match_reference_shapes(arch, shape, multi):
    cfg, sh = jregistry.get_config(arch), JSHAPES[shape]
    mesh = MESHES[multi]
    rules = dict(jshd.DEFAULT_RULES)
    if sh.global_batch < mesh["data"] * mesh.get("pod", 1):
        rules.update({"batch": None, "cache_batch": None})
    got = dryrun.compile_cell(arch, shape, multi)["bytes_per_device"]
    axes = jlm.param_axes(cfg, 16)
    assert got["params"] == _ref_bytes(
        jlm.abstract_params(cfg, 16, jnp.bfloat16), axes, mesh, rules)
    batch = jlm.input_specs(cfg, sh)
    b_axes = jlm.input_axes(cfg, sh)
    if multi and sh.kind == "train":
        # pre-split (pod, B/pod, ...) over pods x data, as the step's
        # specs ("tiers" -> pod, "clients" -> data in the default rules)
        batch = {k: jax.ShapeDtypeStruct((2, v.shape[0] // 2) + v.shape[1:],
                                         v.dtype) for k, v in batch.items()}
        b_axes = {k: ("tiers", "clients") + (None,) * (len(a) - 1)
                  for k, a in b_axes.items()}
    assert got["batch"] == _ref_bytes(batch, b_axes, mesh, rules)
    if sh.kind == "train":
        f32 = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape,
                                                          jnp.float32),
                           jlm.abstract_params(cfg, 16, jnp.bfloat16))
        assert got["opt_state"] == 2 * _ref_bytes(f32, axes, mesh, rules)
        assert "cache" not in got
    else:
        cache = jlm.abstract_cache(cfg, sh.global_batch, sh.seq_len, 16)
        assert got["cache"] == _ref_bytes(cache, jlm.cache_axes_tree(cfg, 16),
                                          mesh, rules)


def test_sync_payload_bytes_follow_the_leaves():
    """The multi-pod cell's bytes on the wire a sync: each leaf's local
    shard at the width, plus a 4-byte scale a row; fp32 has no scale."""
    r = dryrun.compile_cell("qwen2-7b", "train_4k", True)
    s = r["sync_bytes_per_device"]
    p = r["bytes_per_device"]["params"]        # bf16: 2 bytes a value
    assert s["0"] == 2 * p
    assert s["8"] < s["16"] < s["0"] and s["4"] < s["8"]
    rows16, rows8 = s["16"] - p, s["8"] - p // 2
    assert rows16 == rows8 > 0                 # the same row scales
    assert s["4"] - rows8 <= p // 4 + 1


@pytest.mark.parametrize("arch", ["qwen2-7b", "deepseek-moe-16b",
                                  "rwkv6-3b", "zamba2-2.7b",
                                  "paligemma-3b", "hubert-xlarge"])
def test_tp2_param_shapes_match_reference(arch):
    want = flatten_tree(jlm.abstract_params(jsmoke(arch), 2))
    got = flatten_tree(tlm.abstract_params(tsmoke(arch), 2))
    assert sorted(got) == sorted(want)
    for k, t in got.items():
        assert tuple(t.shape) == tuple(want[k].shape), k
        assert t.device.type == "meta" and t.dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ["qwen2-7b", "rwkv6-3b",
                                  "deepseek-moe-16b"])
def test_tp2_loss_matches_reference(arch):
    jc, tc = jsmoke(arch), tsmoke(arch)
    jp = jax.tree.map(np.asarray, jlm.init_params(jc, jax.random.PRNGKey(3),
                                                  2))
    toks = np.random.default_rng(0).integers(0, jc.vocab_size,
                                             (2, 64)).astype(np.int32)
    want, _ = jlm.loss_fn(jc, jax.tree.map(jnp.asarray, jp),
                          {"tokens": jnp.asarray(toks)}, 2)
    with torch.no_grad():
        got, _ = tlm.loss_fn(tc, params_from_numpy(jp, device="cpu"),
                             {"tokens": torch.from_numpy(toks)}, 2)
    assert abs(float(got) - float(want)) <= TP_LOSS_RTOL * abs(float(want))
    # the padded vocab (a multiple of 256 at tp > 1) is what both train
    assert jp["embed"].shape[0] == tc.padded_vocab(2)
