from repro_torch.data.federated import (  # noqa: F401
    ClientData, FederatedDataset, global_test_set, make_federated, pad_stack)
