"""Cohort-scale helpers of the port: the two-pass cross-sample
normalisation (streaming.py)."""
