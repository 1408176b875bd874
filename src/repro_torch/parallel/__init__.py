from repro_torch.parallel.branch import (  # noqa: F401
    branch_parallel, bp_evoformer_block, bp_dap_evoformer_block)
from repro_torch.parallel.mesh_utils import (  # noqa: F401
    refactor_mesh, rename_mesh, axis_size, axis_extent, local_slice)
from repro_torch.parallel.plan import (  # noqa: F401
    ParallelPlan, BuiltPlan, PlanError, auto_plan)
from repro_torch.parallel.grad_sync import (  # noqa: F401
    psum_tree, pmean_tree, compressed_psum_tree, zeros_error_state)
from repro_torch.parallel import dap  # noqa: F401
