"""Host models of the port: genotype likelihoods from pair-HMM scores
(genotype.py) and the CNV candidate intervals pairhmm reads
(candidates.py)."""
