"""Steps, the meshes over processes and devices, and the host-to-device prefetch (port of arp_tpu/parallel/).

A process a GPU (``torch.distributed``, parallel/distributed.py); the (dp, fsdp,
tp, pp) mesh with dcn_dp, JAX's placement rules and the reward engines'
single-process device mesh (parallel/mesh.py); the tp split of the attention
and MLP layers (parallel/tensor_parallel.py); GPipe over the pp axis
(parallel/pipeline.py); the train state wrapped in ``DistributedDataParallel``
or FSDP2 (parallel/step.py)."""

from .distributed import barrier, initialize, process_count, process_index
from .mesh import (LocalMesh, MeshConfig, batch_share, create_mesh, data_share, gather_to_host, mesh_from_count,
                   partition_params)
from .pipeline import create_pp_mesh, pipeline_apply, sequential_apply
from .step import make_eval_step, make_train_step, shard_train_state
from .tensor_parallel import apply_tensor_parallel
