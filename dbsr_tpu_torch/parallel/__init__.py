"""Data parallelism across processes (``multihost``), the device list of one
process (``mesh``) and the burst-frame axis sharded across processes
(``frame_sharding``): port of ``dbsr_tpu/parallel``."""

from dbsr_tpu_torch.parallel.mesh import make_mesh, shard_batch
