"""Graph representation, eps folding, packing and workload synthesis."""
