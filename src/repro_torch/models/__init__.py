"""The paper's evaluation models, functional torch."""
