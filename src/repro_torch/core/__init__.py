"""FedAT core of the port: tiering, weighted aggregation, the event
scheduler, the simulation environment, the round executor and the
event-driven engine with its server strategies (FedAT, FedAvg, TiFL,
FedAsync), the fault plane (faults.py; the gate in steps.py), the
convergence bounds (theory.py) and the legacy ``run_*`` wrappers
(fedat.py, baselines.py)."""
