"""Multi-GPU: one process per card over ``torch.distributed``."""

from wavedm_tpu_torch.parallel.distributed import (initialize_multihost,
                                                   is_coordinator,
                                                   process_count,
                                                   process_index)
from wavedm_tpu_torch.parallel.mesh import (DATA_AXIS, DataMesh, fsdp_shard,
                                            make_mesh, replicate, shard_batch)

__all__ = ["initialize_multihost", "is_coordinator", "process_index",
           "process_count", "DATA_AXIS", "DataMesh", "make_mesh",
           "shard_batch", "replicate", "fsdp_shard"]
