"""Plain reference of the FedAT round on the paper's CNN (Algorithm 1).

Written from the paper and the cell's parameters, in plain PyTorch and
NumPy; it imports nothing of the program.  What the program's set-up
derives from its seeds is worked out again here from frozen copies of the
draws:

* the synthetic non-IID data (``#class`` partitioner, class-template +
  noise images, log-normal client sizes, 80/20 split), in the same
  ``numpy`` stream order, and the padded layout (real rows first);
* the latency profile (the paper's five delay bands), the equal-size
  tiers, the permanent dropouts, and the engine's event order: the tier
  sampled at bootstrap, each round's clients, jitter and seed, in the
  engine stream's order;
* each round's per-epoch shuffles (a CPU ``torch.Generator`` seeded with
  the round's seed: ``randperm`` per slot and epoch).

A round: the downlink codec on the global model; each of the K padded
client slots trains E epochs of prox+Adam on its masked batches (batched
over clients: im2col and one fp32 product a layer, summed in the
card's order); the uplink codec on the
stacked client models; Eq. 4 (sample-weighted average, padded slots
weight 0); the tier slot written; Eq. 3 (reversed update counts).

``prec="tf32"`` runs every convolution and matrix product on operands
rounded to TF32 (10 mantissa bits; fp32 accumulation): the control.
``fault`` plants one of the faults the check must catch:
``"half_batch"`` leaves out half the round's clients (Eq. 4 over the
rest).
"""
from __future__ import annotations

import heapq
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.precision import matmul

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# the initial model: the benchmark's own draw, handed to both sides
# ---------------------------------------------------------------------------

def param_shapes(cfg: Dict) -> Dict[str, Tuple[int, ...]]:
    """HWIO convolutions, a (flat, dense) layer over NHWC-flattened
    features, as the configuration's layout states."""
    k, c, shapes = cfg["kernel"], cfg["channels"], {}
    hw = cfg["image_hw"]
    for i, o in enumerate(cfg["conv_channels"], 1):
        shapes[f"c{i}_w"] = (k, k, c, o)
        shapes[f"c{i}_b"] = (o,)
        c, hw = o, hw // 2
    shapes["d1_w"] = (hw * hw * c, cfg["dense"])
    shapes["d1_b"] = (cfg["dense"],)
    shapes["d2_w"] = (cfg["dense"], cfg["n_classes"])
    shapes["d2_b"] = (cfg["n_classes"],)
    return shapes


def draw_params(cfg: Dict, seed: int, device) -> Params:
    """He-normal weights, zero biases, from one normal draw of a
    generator on ``device`` seeded with ``seed``."""
    shapes = param_shapes(cfg)
    ws = [k for k in sorted(shapes) if k.endswith("_w")]
    n = sum(int(np.prod(shapes[k])) for k in ws)
    g = torch.Generator(device=device).manual_seed(int(seed))
    buf = torch.randn(n, generator=g, device=device, dtype=torch.float32)
    out, off = {}, 0
    for k in sorted(shapes):
        if not k.endswith("_w"):
            out[k] = torch.zeros(shapes[k], device=device)
            continue
        m = int(np.prod(shapes[k]))
        fan_in = int(np.prod(shapes[k][:-1]))
        out[k] = buf[off:off + m].reshape(shapes[k]) * float(
            np.sqrt(2.0 / fan_in))
        off += m
    return out


# ---------------------------------------------------------------------------
# frozen draws of the environment
# ---------------------------------------------------------------------------

def synthesize(data: Dict, need) -> Tuple[np.ndarray, Dict[int, np.ndarray],
                                            Dict[int, np.ndarray]]:
    """(train sizes of every client, train images and labels of the
    clients in ``need``): the ``#class`` image data in its stream order."""
    rng = np.random.default_rng(data["seed"])
    hw, nc = data["image_hw"], data["n_classes"]
    shape = (hw, hw, 3)
    templates = rng.normal(0.0, 2.0, size=(nc,) + shape).astype(np.float32)
    n_clients = data["n_clients"]
    cpc, spc = data["classes_per_client"], data["samples_per_client"]
    n_train = np.empty(n_clients, np.int64)
    xs, ys = {}, {}
    need = set(int(c) for c in need)
    for c in range(n_clients):
        pool = (np.arange(nc) if cpc >= nc
                else rng.choice(nc, cpc, replace=False))
        n = max(int(rng.lognormal(np.log(spc), 0.3)), 20)
        y = rng.choice(pool, n).astype(np.int32)
        # the program's rng.normal(0, 1.0, ...): the same draws
        noise = rng.standard_normal(size=(n,) + shape)
        n_tr = int(0.8 * n)
        n_train[c] = n_tr
        if c in need:
            xs[c] = templates[y[:n_tr]] + noise[:n_tr].astype(np.float32)
            ys[c] = y[:n_tr]
    return n_train, xs, ys


def schedule(spec: Dict, engine_seed: int, n_rounds: int,
             seed_offset: int = 17) -> List[Dict[str, Any]]:
    """The first ``n_rounds`` committed FedAT rounds: tier, live client
    ids, the round's seed and the Eq. 3 weights after its count."""
    data, tiers = spec["data"], spec["tiers"]
    n = data["n_clients"]
    rng = np.random.default_rng(data["seed"])
    lat = np.full(n, float(tiers.get("base_compute", 1.0)))
    bands = tiers["delay_bands"]
    for (lo, hi), ids in zip(bands, np.array_split(rng.permutation(n),
                                                   len(bands))):
        lat[ids] += rng.uniform(lo, hi, size=len(ids))
    order = np.argsort(lat, kind="stable")
    members = [np.sort(s) for s in np.array_split(order, tiers["n_tiers"])]
    drop_ids = rng.choice(n, tiers["n_unstable"], replace=False)
    drop_at = np.full(n, np.inf)
    drop_at[drop_ids] = rng.uniform(*tiers["dropout_window"],
                                    size=tiers["n_unstable"])
    K = tiers["clients_per_round"]
    erng = np.random.default_rng(engine_seed + seed_offset)
    heap: list = []
    clock = {"now": 0.0, "seq": 0}

    def push(delay, actor):
        heapq.heappush(heap, (clock["now"] + delay, clock["seq"], actor))
        clock["seq"] += 1

    def sample(pool):
        if len(pool) == 0:
            return pool
        return erng.choice(pool, min(K, len(pool)), replace=False)

    def latency(ids):
        base = lat[ids]
        return float(np.max(base * (1.0 + erng.uniform(0, 0.1, len(base)))))

    M = tiers["n_tiers"]
    for m in range(M):
        ids = sample(members[m])
        push(latency(ids), (m, ids))
    counts = np.zeros(M, np.int64)
    out = []
    while len(out) < n_rounds and heap:
        clock["now"], _, (m, ids) = heapq.heappop(heap)
        alive = drop_at > clock["now"]
        ids = ids[alive[ids]]
        pool = members[m][alive[members[m]]]
        if len(ids) == 0:
            ids = sample(pool)
            if len(ids):
                push(latency(ids), (m, ids))
            continue
        counts[m] += 1
        c32 = counts.astype(np.float32)
        total = c32.sum(dtype=np.float32)
        cw = (c32[::-1] / np.maximum(total, np.float32(1.0))).astype(
            np.float32)
        seed = int(erng.integers(2 ** 31))
        out.append({"tier": m, "ids": ids.copy(), "seed": seed,
                    "cross_weights": cw})
        nxt = sample(pool)
        if len(nxt):
            push(latency(nxt), (m, nxt))
    return out


def shuffles(seed: int, slots: int, epochs: int, cap: int) -> torch.Tensor:
    """(slots, epochs, cap) shuffles of the sample slots."""
    g = torch.Generator().manual_seed(int(seed))
    return torch.stack([torch.stack([torch.randperm(cap, generator=g)
                                     for _ in range(epochs)])
                        for _ in range(slots)])


def visited_real_samples(seed: int, n_real: List[int], slots: int,
                         epochs: int, cap: int, batch: int) -> int:
    """Real (unmasked) samples the live clients' local epochs visit: the
    first ``cap // batch * batch`` shuffled slots of each epoch, of which
    slots below the client's size hold its rows."""
    perm = shuffles(seed, slots, epochs, cap)[:len(n_real), :,
                                              :cap // batch * batch]
    lim = torch.tensor(n_real)[:, None, None]
    return int((perm < lim).sum())


# ---------------------------------------------------------------------------
# the round
# ---------------------------------------------------------------------------

def codec_roundtrip(x: torch.Tensor, bits: int, block: int = 256
                    ) -> torch.Tensor:
    """Blockwise fixed-point quantize-dequantize of the flat leaf: blocks
    of ``block`` values, scale max|block| times the fp32 reciprocal of
    qmax (the card's order), codes x / scale rounded half to even and
    clamped to +-qmax."""
    qmax = (1 << (bits - 1)) - 1
    flat = x.reshape(-1)
    n = flat.numel()
    nb = -(-n // block)
    blocks = F.pad(flat, (0, nb * block - n)).reshape(nb, block)
    inv = torch.tensor(1.0 / qmax, dtype=torch.float32, device=x.device)
    scale = torch.clamp_min(blocks.abs().amax(dim=1) * inv, 1e-30)
    q = torch.clamp(torch.round(blocks / scale[:, None]), -qmax, qmax)
    return (q * scale[:, None]).reshape(-1)[:n].reshape(x.shape)


def lossy(tree: Params, bits: int) -> Params:
    """The link's quantize-dequantize (identity for ``bits`` 0)."""
    if not bits:
        return tree
    return {k: codec_roundtrip(v, bits) for k, v in tree.items()}


def conv_same(h: torch.Tensor, w: torch.Tensor, prec: str) -> torch.Tensor:
    """Every client's SAME stride-1 convolution as im2col and one batched
    fp32 product, summed in the card's order (the patch's rows, columns,
    then channels): h (K, B, H, W, C), w (K, kh, kw, C, O) -> (K, B, H, W,
    O)."""
    K, B, H, W, C = h.shape
    kh, kw, _, O = w.shape[1:]
    hp = F.pad(h, (0, 0, kw // 2, kw // 2, kh // 2, kh // 2))
    cols = torch.cat([hp[:, :, i:i + H, j:j + W, :] for i in range(kh)
                      for j in range(kw)], dim=-1)
    y = matmul(cols.reshape(K, B * H * W, kh * kw * C),
               w.reshape(K, kh * kw * C, O), prec)
    return y.reshape(K, B, H, W, O)


def pool2(h: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 max-pool over (H, W) of (K, B, H, W, C)."""
    K, B, H, W, C = h.shape
    return h.reshape(K, B, H // 2, 2, W // 2, 2, C).amax(dim=(3, 5))


def cnn_logits(p: Params, x: torch.Tensor, n_conv: int, prec: str
               ) -> torch.Tensor:
    """Client-batched CNN: params (K, ...), images (K, B, H, W, C) ->
    (K, B, classes)."""
    h = x
    for i in range(1, n_conv + 1):
        h = conv_same(h, p[f"c{i}_w"], prec) \
            + p[f"c{i}_b"][:, None, None, None, :]
        h = pool2(torch.relu(h))
    f = h.reshape(h.shape[0], h.shape[1], -1)     # NHWC rows of d1
    f = torch.relu(matmul(f, p["d1_w"], prec) + p["d1_b"][:, None, :])
    return matmul(f, p["d2_w"], prec) + p["d2_b"][:, None, :]


def local_train(w_sent: Params, x, y, mask, perms, rt: Dict, n_conv: int,
                prec: str) -> Params:
    """E epochs of prox+Adam for every client slot from ``w_sent``: a
    masked mean cross-entropy plus (lambda/2) ||w - w_sent||^2, Adam with
    bias correction (fp32 constants)."""
    K, cap = y.shape
    bs, lr, lam = rt["batch_size"], rt["lr"], rt["prox_lambda"]
    g0 = {k: v.unsqueeze(0).expand((K,) + tuple(v.shape)).clone()
          for k, v in w_sent.items()}
    p = {k: v.clone() for k, v in g0.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    rows = torch.arange(K, device=x.device)[:, None]
    t = 0
    for e in range(rt["local_epochs"]):
        for i in range(cap // bs):
            idx = perms[:, e, i * bs:(i + 1) * bs]
            xb, yb, mb = x[rows, idx], y[rows, idx], mask[rows, idx]
            leaves = {k: p[k].detach().requires_grad_(True) for k in p}
            with torch.enable_grad():
                logits = cnn_logits(leaves, xb, n_conv, prec)
                onehot = F.one_hot(yb, logits.shape[-1]).to(logits.dtype)
                nll = -(onehot * torch.log_softmax(logits, -1)).sum(-1)
                ce = (nll * mb).sum(1) / mb.sum(1).clamp_min(1.0)
                prox = sum((leaves[k] - g0[k]).square().flatten(1).sum(1)
                           for k in sorted(leaves))
                obj = (ce + 0.5 * lam * prox).sum()
                grads = torch.autograd.grad(obj, [leaves[k] for k in leaves])
            t += 1
            c1 = float(np.float32(1) - np.float32(0.9) ** np.float32(t))
            c2 = float(np.float32(1) - np.float32(0.999) ** np.float32(t))
            with torch.no_grad():
                for k, g in zip(leaves, grads):
                    m[k] = 0.9 * m[k] + 0.1 * g
                    v2[k] = 0.999 * v2[k] + 0.001 * g * g
                    p[k] = p[k] - lr * (m[k] / c1) / (
                        torch.sqrt(v2[k] / c2) + 1e-8)
    return p


def weighted_sum(stack: Params, w: torch.Tensor) -> Params:
    """sum_i w_i leaf_i over the leading axis, products formed first."""
    return {k: (v * w.reshape((-1,) + (1,) * (v.dim() - 1))).sum(0)
            for k, v in stack.items()}


def fedat_round(w_in: Params, stack: Params, rnd: Dict, data, rt: Dict,
                bits: int, n_conv: int, prec: str = "fp32",
                fault: Optional[str] = None) -> Tuple[Params, Params]:
    """One round; ``data`` is (n_train (all clients), images, labels) and
    ``stack`` the (M, ...) tier models, written in place."""
    n_train, xs, ys = data
    ids = list(rnd["ids"])
    if fault == "half_batch":
        ids = ids[:max(1, len(ids) // 2)]
    K, E = rt["clients_per_round"], rt["local_epochs"]
    cap = int(n_train.max())
    dev = next(iter(w_in.values())).device
    slots = ids + [ids[0]] * (K - len(ids))
    hw = xs[slots[0]].shape[1]
    x = np.zeros((K, cap, hw, hw, 3), np.float32)
    y = np.zeros((K, cap), np.int64)
    mask = np.zeros((K, cap), np.float32)
    for s, c in enumerate(slots):
        n = len(ys[c])
        x[s, :n], y[s, :n], mask[s, :n] = xs[c], ys[c], 1.0
    x, y, mask = (torch.from_numpy(a).to(dev) for a in (x, y, mask))
    ns = np.zeros(K, np.float32)
    ns[:len(ids)] = n_train[ids]
    w4 = ns / np.maximum(ns.sum(dtype=np.float32), np.float32(1.0))
    perms = shuffles(rnd["seed"], K, E, cap).to(dev)
    w_sent = lossy(w_in, bits)
    clients = lossy(local_train(w_sent, x, y, mask, perms, rt, n_conv,
                                prec), bits)
    tier = weighted_sum(clients, torch.from_numpy(w4).to(dev))
    for k in stack:
        stack[k][rnd["tier"]] = tier[k]
    cw = torch.from_numpy(np.asarray(rnd["cross_weights"], np.float32))
    return weighted_sum(stack, cw.to(dev)), stack


def _host(tree: Params) -> Params:
    return {k: v.detach().cpu().clone() for k, v in tree.items()}


def checked_rounds(rounds: List[Dict[str, Any]], fold_rounds: int
                   ) -> Optional[List[int]]:
    """The rounds the check compares: the first, and ``fold_rounds``
    rounds from the first whose Eq. 3 puts weight on a tier slot some
    round has trained (so that round folds a trained model into the
    global one and the rounds after it start from a mixed global model).
    None if ``rounds`` hold no such fold."""
    trained = set()
    for i, r in enumerate(rounds):
        trained.add(r["tier"])
        if any(w > 0 and m in trained
               for m, w in enumerate(r["cross_weights"])):
            return sorted({0} | set(range(i, i + fold_rounds)))
    return None


def needed_rounds(rounds: List[Dict[str, Any]], checked: List[int],
                  n_tiers: int) -> set:
    """The rounds whose local training the checked rounds' models depend
    on: each checked round, and the last writer of every slot that the
    Eq. 3 fold before a needed round (its input) or after a checked round
    (its output) weights.  A slot of weight 0 adds exactly 0 to the fold,
    whatever it holds, so the other rounds need not be trained."""
    last: List[Optional[int]] = [None] * n_tiers
    writers = []
    for i, r in enumerate(rounds):
        last[r["tier"]] = i
        writers.append(list(last))
    need = set(checked)
    for i in range(max(checked), -1, -1):
        if i not in need:
            continue
        folds = ([i - 1] if i > 0 else []) + ([i] if i in checked else [])
        for f in folds:
            for m, w in enumerate(rounds[f]["cross_weights"]):
                if w > 0 and writers[f][m] is not None:
                    need.add(writers[f][m])
    return need


def observe(spec: Dict, cfg: Dict, engine_seed: int, w0: Params,
            checked: List[int], prec: str = "fp32",
            fault: Optional[str] = None, data=None,
            starts: Optional[Dict[int, Params]] = None
            ) -> List[Dict[str, Any]]:
    """The ``checked`` rounds from the seed, as the driver observes the
    program's: per round the input global model (``w_in``), the tier slot
    it wrote and the global model after it (host tensors), all on the
    reference's own chain from ``w0``.  Where ``starts`` gives a checked
    round another input (the program's own), ``slot`` is that round
    trained from it instead (``start``), on a copy of the tier stack:
    after a fold of trained slots, the quantize8 downlink and Adam's
    steps amplify the chains' round-off past what the round's own
    computation shows."""
    rounds = schedule(spec, engine_seed, max(checked) + 1)
    M = spec["tiers"]["n_tiers"]
    need = needed_rounds(rounds, checked, M)
    rt = dict(spec["engine"], clients_per_round=spec["tiers"][
        "clients_per_round"])
    if data is None:
        data = synthesize(spec["data"], {int(c) for i in need
                                         for c in rounds[i]["ids"]})
    codec = spec["transport"]["codec"]
    bits = 0 if codec == "none" else int(codec.replace("quantize", ""))
    stack = {k: torch.stack([v] * M) for k, v in w0.items()}
    obs = []
    for i in sorted(need):
        r = rounds[i]
        w_in = w0 if i == 0 else weighted_sum(
            stack, torch.from_numpy(rounds[i - 1]["cross_weights"]).to(
                next(iter(w0.values())).device))
        start = w_in
        if i in checked and starts is not None and any(
                not torch.equal(starts[i][k], w_in[k].cpu()) for k in w_in):
            start = {k: v.to(w_in[k].device) for k, v in starts[i].items()}
            _, other = fedat_round(start, {k: v.clone()
                                           for k, v in stack.items()},
                                   r, data, rt, bits,
                                   len(cfg["conv_channels"]), prec, fault)
        w, stack = fedat_round(w_in, stack, r, data, rt, bits,
                               len(cfg["conv_channels"]), prec, fault)
        if i in checked:
            slot = stack if start is w_in else other
            obs.append({"round": i, "w_in": _host(w_in),
                        "start": _host(start),
                        "slot": _host({k: v[r["tier"]]
                                       for k, v in slot.items()}),
                        "w_out": _host(w)})
    return obs
