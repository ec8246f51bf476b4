"""streaming layer of the PyTorch port (mirrors ``repro.streaming``)."""
