"""Eval data layer: codecs, resizes, the native JPEG loader, the MVS
dataset and its DataLoader (counterpart of diffmvs_tpu/data/, without the
training datasets)."""
