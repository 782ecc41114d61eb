"""Synthetic data and federated partitioning (numpy)."""
