"""Batched probe of a sorted run (the LSM read hot spot)."""
