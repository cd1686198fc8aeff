"""mfu.fedat: model FLOPs of the local training the window committed,
counted on the real (unmasked) samples the live clients' epochs visited
(counts/cnn.py: 3 forwards of 16.06 MFLOP a 32x32x3 image), over the
window and the card's published fp32 peak."""
from portbench.counts import cnn


def read(rec):
    n, peaks = rec["counters"].get("real_samples"), rec.get("peaks")
    if not n or not peaks:
        return None
    t0, t1 = rec["window"]
    flops = cnn.train_flops(rec["config"], n)
    return 100.0 * flops / (t1 - t0) / peaks["fp32_flops"]
