"""Configuration the port shares with the JAX package's ``config.py``.

Only the pretraining curriculum for now: its three stages, each a dataset
name and its node-feature width (exp_pretraining.py:218-219).
"""

PRETRAIN_STAGES = (("PCQM4Mv2", 9), ("QM9", 11), ("mol-PCBA", 9))
