"""Simulation-experiment launcher: the declarative spec CLI under the
launch namespace (``launch/train.py`` drives the trainer; this drives the
paper-scale FL simulation).

    PYTHONPATH=src python -m repro_torch.launch.sim --device cpu \
        --set strategy.name=fedat --sweep transport.codec=none,quantize8

Delegates to :mod:`repro_torch.api.cli`; see that module for the flags.
"""
from repro_torch.api.cli import main

if __name__ == "__main__":
    main()
