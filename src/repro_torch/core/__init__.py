"""core layer of the PyTorch port (mirrors ``repro.core``)."""
