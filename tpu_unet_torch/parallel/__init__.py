"""Multi-process parallelism over ``torch.distributed`` (counterpart of
``tpu_unet/parallel``): the mesh and data parallelism, the halo exchange,
and process-group start-up."""

from tpu_unet_torch.parallel.mesh import (
    make_mesh,
    replicate,
    shard_batch,
    make_dp_train_step,
    make_dp_tile_forward,
)
from tpu_unet_torch.parallel.halo import (
    halo_strip_inference,
    make_dp_halo_train_step,
    make_halo_train_step,
)
from tpu_unet_torch.parallel.distributed import initialize_multihost
