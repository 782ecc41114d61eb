"""RoundState checkpoints: `.npz` archives and checkpoint directories."""
