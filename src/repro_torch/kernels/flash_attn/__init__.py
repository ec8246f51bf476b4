"""Forward attention (prefill) with causal, sliding-window and chunk masks."""
