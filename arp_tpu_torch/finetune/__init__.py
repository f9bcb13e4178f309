"""ARP-DT+: the CLIP multiscale adapter, its fine-tuning CLI and its reward engine (port of arp_tpu/finetune)."""
