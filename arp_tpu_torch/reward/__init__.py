"""Reward labeling: the CLIP reward engine and the HDF5 labeler."""
