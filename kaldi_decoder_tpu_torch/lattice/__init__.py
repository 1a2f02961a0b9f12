"""Host lattice pruning."""
