"""The distributed runtime on ``torch.distributed`` — counterpart of
``sgl_tpu/parallel``: the ``(data, graph)`` mesh, the ring propagation with
K3/K4 per bucket, the node-sharded hop stack and the data-parallel step.
One process per rank; ``torchrun`` or an explicit ``init_method`` makes the
group, and a lone process runs as a one-rank mesh."""

from sgl_tpu_torch.parallel.mesh import (  # noqa: F401
    data_sharding,
    init_distributed,
    make_mesh,
    rank_device,
    replicated,
)
from sgl_tpu_torch.parallel.spmm_dist import (  # noqa: F401
    DistAdj,
    DistChunkedAdj,
    ShardedHops,
    k_hop_propagate_dist,
    make_dist_spmm,
    pad_features,
    partition_adj,
    partition_adj_chunked,
    ring_bucket_work_time,
    ring_padding_stats,
)
from sgl_tpu_torch.parallel.train_dist import make_parallel_train_step, replicate_state  # noqa: F401
