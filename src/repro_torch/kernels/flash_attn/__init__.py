"""Forward attention (prefill) with causal and sliding-window masks."""
