"""Cohort-scale helpers of the port: the two-pass cross-sample
normalisation (streaming.py), the cohort manifest (manifest.py), the
chunked PCA (pca.py) and the chunked, incremental ``cohortscan`` engine
(scan.py)."""
