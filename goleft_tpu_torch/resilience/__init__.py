"""Resilience of the port: deterministic fault injection (faults.py),
the retry policy with quarantine (policy.py) and the checkpoint store
(checkpoint.py), trimmed copies of the JAX package's modules of the same
names."""
