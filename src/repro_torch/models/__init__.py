"""Models of the port: the paper's CNN and logistic regression, batched
over clients, and the FLModel registry the federated path builds from."""
