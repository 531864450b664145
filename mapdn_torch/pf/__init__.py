from mapdn_torch.pf.newton import (
    PFResult, branch_results, bus_injections, nr_solve, nr_solve_dense,
    packed_operators)
from mapdn_torch.pf.fused_nr import (
    NRContext, NRSmallContext, get_ctx, get_ctx_small, make_solver,
    nr_solve_large, nr_solve_large_ref, nr_solve_small, nr_solve_small_ref)
