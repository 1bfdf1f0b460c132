"""Several devices from one process: batches and the pipelined ensemble
(``mesh``), the cycle ring (``ring``), the sharded sweep
(``sweep_sharded``) and the Krylov operators on one device or row-sharded
(``krylov_ops``)."""

from .krylov_ops import CycleOps, ShardedCycleOps, sharded_dense_ops  # noqa: F401
from .mesh import (batched_pschur_complex, batched_pschur_real,  # noqa: F401
                   ensemble_pschur_real_pipelined, make_mesh)
from .ring import ring_cycle_products, ring_product_apply  # noqa: F401
from .sweep_sharded import (ShardedSweep, chase_sweep_sharded,  # noqa: F401
                            pschur_real_sharded)
