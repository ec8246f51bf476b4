"""Entry points: ``serve`` (prefill + greedy decode)."""
