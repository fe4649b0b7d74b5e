from umeregrobust_tpu_torch.parallel.mesh import P, make_mesh, replicate, shard_batch
from umeregrobust_tpu_torch.parallel.points_sharded import (
    local_moments, points_block, ume_from_ball_query_sp)
