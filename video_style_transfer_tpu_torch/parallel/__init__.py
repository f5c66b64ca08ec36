"""Multi-process data and frame parallelism on torch.distributed: the
process group and its collectives (``distributed``), and the (data,
frame) grid of ranks with the global-batch helpers (``mesh``)."""
from video_style_transfer_tpu_torch.parallel.mesh import (  # noqa: F401
    FrameShard, Grid, create_mesh, shard_rows)
