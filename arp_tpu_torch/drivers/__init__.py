"""Drivers that run the whole pipeline through the port's CLIs (ports of the JAX package's
``scripts/reproduce_paper.py`` and ``scripts/stub_benchmark.py``):

    python -m arp_tpu_torch.drivers.reproduce_paper --smoke --device cpu
    python -m arp_tpu_torch.drivers.stub_benchmark --smoke --device cpu

Both read and write HDF5 demonstrations, so they need ``h5py``.
"""
