"""Research extras of the port (counterpart of `cpc2_tpu/research/`)."""
