"""Multi-device receivers on ``torch.distributed`` (counterpart of ``qampy_tpu/parallel``).

One process per rank, each on its own time shard (``sharded.make_sharded_rx_chain``)
or its own frames (``sharded.make_sharded_pilot_rx``); the ranks exchange halos,
boundary phases and taps through the collectives of a :class:`mesh.Mesh`, made of
``all_reduce`` and ``broadcast`` alone so that they run on NCCL and on gloo.
"""
from qampy_tpu_torch.parallel.mesh import init_distributed, make_mesh, time_axis
from qampy_tpu_torch.parallel import sharded
