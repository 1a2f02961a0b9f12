"""Utilities: decode statistics, WER and profiling hooks."""
