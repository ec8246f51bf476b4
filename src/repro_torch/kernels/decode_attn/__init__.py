"""Decode attention: one query token against a KV cache."""
