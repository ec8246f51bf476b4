"""Plain float32 references, one module a model family.  They import
nothing of the program and take nothing it made: the benchmark hands
them the same seed-drawn weights and inputs it hands the program."""
