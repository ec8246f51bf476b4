"""Keyed segment sum (the LSM weight reduction)."""
