"""Host and device models of the port: genotype likelihoods from
pair-HMM scores (genotype.py), the CNV candidate intervals (candidates.py),
and the EM copy-number caller and cn.mops (emdepth.py, mops.py)."""
