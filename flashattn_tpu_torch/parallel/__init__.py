"""Parallelism over ``torch.distributed``, one process a rank (counterpart
of flashattn_tpu/parallel): named meshes, the TP / FSDP sharding rules,
sharded and ring attention, and the GPipe pipeline."""

from .mesh import (DATA_AXIS, MODEL_AXIS, SEQ_AXIS, P, PartitionSpec,
                   batch_sharding, create_mesh, default_mesh,
                   init_distributed, local_shard, replicated, unshard)
from .pipeline import (
    STAGE_AXIS,
    megatron_layer_fn,
    megatron_stage_specs,
    pipeline_apply,
    scan_stage_fn,
    shard_stage_params,
    split_layers_into_stages,
    stack_stage_params,
    stage_sharding,
)
from .sharded_attention import (ring_flash_attention,
                                sharded_flash_attention,
                                sharded_paged_attention)
from .sharding import (apply_mesh, fsdp_sharding_tree, fsdp_spec_for,
                       shard_model, sharding_tree, tp_spec_for)
