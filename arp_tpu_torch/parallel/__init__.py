"""One-device train and eval steps and the host-to-device prefetch (port of arp_tpu/parallel/).

The mesh, the sharded train state and the multi-device helpers are not
ported (ROADMAP, several GPUs)."""
