from tpu3drec_torch.parallel.mesh import make_mesh, default_mesh_shape
from tpu3drec_torch.parallel.pairs import (
    make_batched_pair_step, tp_knn2, sharded_pair_stats,
)
