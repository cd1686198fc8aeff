from repro_torch.data.federated import (  # noqa: F401
    ClientData, FederatedDataset, make_federated, pad_stack)
