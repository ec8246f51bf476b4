"""data layer of the PyTorch port (mirrors ``repro.data``)."""
