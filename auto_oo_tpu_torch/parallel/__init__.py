"""The port's parallel axes over torch.distributed (port of
auto_oo_tpu/parallel/): meshes and process groups (``distributed``),
the tangent-sharded Newton steps and the geometry batch (``sharding``),
the row-sharded and the hosted x row-sharded string-grid engines
(``grid_sharded``, ``grid_hosted_sharded``) and statevector / ERI
sharding (``statevector``).  NCCL on the card, gloo on the CPU;
``distributed.run_ranks`` spawns gloo ranks on the CPU."""

from .distributed import global_mesh, initialize_distributed
from .grid_hosted_sharded import hosted_sharded_fns
from .grid_sharded import (grid2d_nr_fns, row_sharded_gradient_optimization,
                           row_sharded_sector_fns)
from .sharding import (GeometryBatch, make_mesh, sharded_full_hessian_fn,
                       sharded_grad_hess_fn, sharded_nr_step_fn)
from .statevector import (sharded_energy_fn, sharded_int2e_transform_fn,
                          sharded_rdms_fn, sharded_state_fn)

__all__ = ["make_mesh", "sharded_full_hessian_fn", "sharded_grad_hess_fn",
           "sharded_nr_step_fn", "GeometryBatch", "sharded_state_fn",
           "sharded_rdms_fn", "sharded_int2e_transform_fn",
           "sharded_energy_fn", "row_sharded_sector_fns",
           "row_sharded_gradient_optimization", "grid2d_nr_fns",
           "initialize_distributed", "global_mesh", "hosted_sharded_fns"]
