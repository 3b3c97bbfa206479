"""Point-cloud fusion on the card, PLY files, and point-cloud metrics
(counterpart of diffmvs_tpu/fusion/)."""
