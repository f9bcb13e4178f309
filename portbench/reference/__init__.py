"""Plain PyTorch and NumPy versions of what the benchmark's cells compute, in float32 with TF32 off.

Nothing here imports the program (arp_tpu_torch) or JAX: the reference is handed the
weights and inputs that the benchmark made and works out again whatever the program
derived from them.
"""
