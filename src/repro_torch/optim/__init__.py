"""Optimizers on tensor trees (`optim.sgd`)."""
