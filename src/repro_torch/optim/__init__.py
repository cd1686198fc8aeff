from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer, adam, adamw, sgd, cosine_schedule, global_norm)
