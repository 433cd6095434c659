"""Multi-device execution (``multihmr_tpu/parallel``): the (data, model) mesh
and the weights' layout on it (``sharding``), the collectives (``comm``),
ring and head-parallel attention (``ring_attention``), data-parallel
inference in one process (``infer``), spawned ranks (``launch``) and the CPU
dryrun (``dryrun``)."""

from multihmr_tpu_torch.parallel.infer import DataParallel, folder_inference  # noqa: F401
from multihmr_tpu_torch.parallel.ring_attention import (  # noqa: F401
    head_parallel_attention,
    mesh_attention,
    mesh_attention_merged,
    mesh_attention_t,
    ring_attention,
    sequence_parallel_attention,
)
from multihmr_tpu_torch.parallel.sharding import (  # noqa: F401
    apply_fsdp,
    gather_state_dict,
    make_mesh,
    shard_batch,
    shard_state_dict,
)
