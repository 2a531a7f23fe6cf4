"""Data parallelism of the port (``mesh.py``)."""
from .mesh import (TENSOR_PARALLEL, DataMesh, make_mesh, running_stats,
                   set_sync_batchnorm, shutdown)
