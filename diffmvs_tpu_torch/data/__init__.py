"""Data layer: codecs, resizes, the native JPEG loader, the eval MVS
dataset, the DTU and BlendedMVS training datasets, the benchmark scene
lists and the DataLoader (counterpart of diffmvs_tpu/data/)."""
