"""arp_tpu_torch: the ARP-TPU reward-labeling path in PyTorch and CUDA for an NVIDIA H100.

A port of ``arp_tpu`` (JAX, Flax and Pallas on a TPU), laid out like it so
that each module's counterpart is easy to find.  ``arp_tpu`` stays the
reference the port is tested against; this package imports ``torch`` and
never ``jax`` or ``flax``.

Every TPU kernel on the ported path is a kernel written by hand for Hopper
(``csrc/``), built with nvcc at first use (``ops/_build.py``).  A tensor on the
CPU goes through the kernel's plain PyTorch version; a CUDA tensor goes
through the kernel or the call raises.
"""

__version__ = "0.1.0"
