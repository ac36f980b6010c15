"""Multi-device decode over a ``torch.distributed`` DeviceMesh, the
counterpart of ``ffpic_tpu/parallel``."""

from ffpic_tpu_torch.parallel.mesh import (
    make_mesh,
    shard_batch,
    sharded_decode_420,
)

__all__ = ["make_mesh", "shard_batch", "sharded_decode_420"]
