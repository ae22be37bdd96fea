"""TPC-H answers, one module per query, over the generator's raw columns."""
