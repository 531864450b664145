from mapdn_torch.grid.model import Grid, build_ybus, make_grid
from mapdn_torch.grid.cases import CASES, make_case
