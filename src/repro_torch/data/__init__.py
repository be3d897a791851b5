"""Synthetic tasks and the federated partitioner."""
