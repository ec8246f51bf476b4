"""state layer of the PyTorch port (mirrors ``repro.state``)."""
