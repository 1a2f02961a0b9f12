"""Batched frontier ops: GetCutoff, dedup and selection."""
