"""Train and eval steps, the data mesh over processes and the host-to-device prefetch (port of arp_tpu/parallel/).

A process a GPU (``torch.distributed``, parallel/distributed.py); the data
axes dp, fsdp and dcn_dp (parallel/mesh.py); the train state wrapped in
``DistributedDataParallel`` or FSDP2 (parallel/step.py).  Tensor and pipeline
parallelism (``partition_params``' tp rules, ``pipeline.py``) are ROADMAP
Queue 1 item 12c; the engines' single-process local-device mesh
(``mesh_from_count``) is item 12b."""

from .distributed import barrier, initialize, process_count, process_index
from .mesh import MeshConfig, batch_share, create_mesh, data_share, gather_to_host
from .step import make_eval_step, make_train_step, shard_train_state
