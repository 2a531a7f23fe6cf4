"""Data and tensor parallelism of the port (``mesh.py``, ``tensor.py``)."""
from .mesh import (DataMesh, gather_optimizer_state, gather_state_dict,
                   make_mesh, param_spec, running_stats, set_sync_batchnorm,
                   shard_model, shard_optimizer_state, shard_plan,
                   shard_state_dict, shutdown)
