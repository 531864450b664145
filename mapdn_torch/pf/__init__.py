from mapdn_torch.pf.newton import (
    PFResult, branch_results, bus_injections, nr_solve, packed_operators)
from mapdn_torch.pf.fused_nr import (
    NRSmallContext, get_ctx_small, make_solver, nr_solve_small,
    nr_solve_small_ref)
