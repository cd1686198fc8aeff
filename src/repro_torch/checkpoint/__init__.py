from repro_torch.checkpoint.ckpt import (  # noqa: F401
    CheckpointManager,
    SIDECAR,
    read_sidecar,
    write_sidecar,
)
