"""Trainer (port of arp_tpu/train/): the shared building blocks and the CLI."""
