"""Traffic generators: each reads a cell's parameters and ``--seed`` and
makes the inputs both the program and the references are given."""
