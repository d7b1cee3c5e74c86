"""See the package docstring of goleft_tpu_torch."""
