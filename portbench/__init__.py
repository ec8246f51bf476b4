"""The port's benchmark: one entry point, ``python3 -m portbench.run``,
driven by the files beside it (see ``run.py``)."""
