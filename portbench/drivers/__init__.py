"""One driver a kind of cell: ``run(cell) -> record`` (see harness.py)."""
