"""The frozen counts against the configurations and against the port's
own models, and the kernel bounds against the kernel table's figures."""
from portbench import harness
from portbench.counts import cnn, kernels
from portbench.testing import SRC

PEAKS = {"hbm_bytes": 3.35e12, "fp32_flops": 67e12}


def _cfg(name):
    return harness.load_json(harness.PB / "configs" / f"{name}.json")


def test_cnn_counts():
    c = _cfg("cnn-cifar10")
    assert cnn.params(c) == c["params"] == 122570
    assert cnn.forward_flops(c) == 16_057_600


def test_cnn_counts_match_the_port(monkeypatch):
    monkeypatch.syspath_prepend(SRC)
    import torch
    from repro_torch.models import cnn as port_cnn
    p = port_cnn.cnn_init(torch.Generator().manual_seed(0), (32, 32, 3), 10)
    assert sum(v.numel() for v in p.values()) == 122570
    from portbench.reference import fedat
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        fedat.param_shapes(_cfg("cnn-cifar10"))


def test_b1_bound():
    # PR 16: 1,225,700 values a roundtrip, 9,805,600 B, 0.00293 ms
    assert kernels.b1_roundtrip_bytes(1_225_700) == 9_805_600
    assert abs(kernels.bound_s(9_805_600, 0, PEAKS) * 1e3 - 0.00293) < 1e-5
