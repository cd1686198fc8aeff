"""Frozen operation and byte counts: model FLOPs from a configuration's
shapes, the kernels' roofline bounds and the card's published peaks."""
