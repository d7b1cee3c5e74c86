"""Resilience of the port: deterministic fault injection (faults.py) and
the retry policy with quarantine (policy.py), trimmed copies of the JAX
package's modules of the same names."""
