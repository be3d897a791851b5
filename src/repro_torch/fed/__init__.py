"""Federated-learning runtime: the round and its kernels backend."""
