"""Stage 1's host half (port of arp_tpu/collect/): recording demos to HDF5, fusing and downsizing them."""
