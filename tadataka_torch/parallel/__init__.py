"""Multi-device and multi-process paths (counterpart of
``tadataka_tpu/parallel``): meshes and their collectives, the row- and
column-sharded semi-dense depth update, landmark-sharded bundle
adjustment, and the multi-process launch."""

from tadataka_torch.parallel.mesh import make_mesh, default_mesh
from tadataka_torch.parallel.distributed_ba import (
    distributed_lm_solve, shard_observations)
from tadataka_torch.parallel.sharded_semi_dense import sharded_update_depth
from tadataka_torch.parallel.sharded_semi_dense import (
    make_sharded_update_sweep)
from tadataka_torch.parallel.multihost import (
    initialize_distributed, make_host_mesh)
