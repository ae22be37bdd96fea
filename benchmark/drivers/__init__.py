"""One module per kind of configuration: it makes the inputs from the seed,
drives the program through one call per step, and judges the outputs."""
