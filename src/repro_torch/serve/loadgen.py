"""Open-loop load generation + latency/throughput reporting (the port of
``repro/serve/loadgen.py``: numpy only, so arrivals and prompts equal the
reference's bit for bit).

Open loop means arrivals are scheduled ahead of time from a Poisson
process (exponential inter-arrival gaps at ``rate`` req/s) and do *not*
wait for the server — the standard way to measure latency under load
without the coordinated-omission bias of closed-loop clients.  Arrivals
and prompts are deterministic in ``seed``, so a bench row is reproducible
run to run (only the measured wall-clock timings vary).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.serve.engine import ServeRequest


def poisson_arrivals(n: int, rate: float, seed: int) -> np.ndarray:
    """(n,) cumulative arrival offsets (seconds) for a Poisson process
    at ``rate`` req/s; ``rate <= 0`` means all arrive at t=0 (a closed
    burst — the max-pressure load level)."""
    if rate <= 0:
        return np.zeros(n)
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / rate, size=n))


def make_requests(n: int, rate: float, prompt_len: int, max_new: int,
                  vocab_size: int, seed: int) -> List[ServeRequest]:
    """``n`` requests with Poisson arrivals and random prompts of length
    4..prompt_len (deterministic in ``seed``)."""
    rng = np.random.default_rng(seed)
    arrivals = poisson_arrivals(n, rate, seed)
    out = []
    for i in range(n):
        plen = int(rng.integers(4, prompt_len + 1))
        prompt = rng.integers(0, vocab_size, plen).astype(np.int32)
        out.append(ServeRequest(rid=i, prompt=prompt, max_new=max_new,
                                arrival=float(arrivals[i])))
    return out


def _pct(xs: List[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs), q)) if xs else float("nan")


def report(done: List[ServeRequest]) -> Dict[str, float]:
    """p50/p95/p99 request latency + TTFT + queueing, and throughput.

    * latency      — arrival -> last token (the user-visible number)
    * ttft         — arrival -> first generated token
    * queueing     — arrival -> slot admission (load-level signal)
    * tok_per_s    — generated tokens / makespan (engine start -> last
                     completion), the serving-throughput headline
    """
    lat = [r.t_done - r.arrival for r in done if r.t_done >= 0]
    ttft = [r.t_first - r.arrival for r in done if r.t_first >= 0]
    queue = [r.t_admit - r.arrival for r in done if r.t_admit >= 0]
    toks = sum(len(r.out) for r in done)
    makespan = max((r.t_done for r in done if r.t_done >= 0), default=0.0)
    return {
        "requests": len(done),
        "truncated": sum(1 for r in done if r.truncated),
        "tokens": toks,
        "makespan_s": makespan,
        "tok_per_s": toks / makespan if makespan > 0 else float("nan"),
        "latency_p50_s": _pct(lat, 50),
        "latency_p95_s": _pct(lat, 95),
        "latency_p99_s": _pct(lat, 99),
        "ttft_p50_s": _pct(ttft, 50),
        "ttft_p95_s": _pct(ttft, 95),
        "queueing_p50_s": _pct(queue, 50),
        "queueing_p95_s": _pct(queue, 95),
    }
