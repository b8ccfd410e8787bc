"""Device meshes, data-parallel training and evaluation, instance sharding
and fold fan-out (counterpart of ``montecarlo_gated_mil_tpu/parallel``)."""

from montecarlo_gated_mil_tpu_torch.parallel.dp import (  # noqa: F401
    BucketBatcher,
    make_dp_mc_eval,
    make_dp_train_step,
)
from montecarlo_gated_mil_tpu_torch.parallel.mesh import (  # noqa: F401
    data_sharded,
    make_mesh,
    replicated,
    shard_batch,
)
from montecarlo_gated_mil_tpu_torch.parallel.instance import (  # noqa: F401
    mc_inference_sharded,
    sharded_embed,
    sharded_embed_grad,
    sharded_gated_attention,
    sharded_mc_gated_attention,
)
from montecarlo_gated_mil_tpu_torch.parallel.distributed import (  # noqa: F401
    allgather_fold_accuracies,
    fold_assignment,
    initialize,
)
