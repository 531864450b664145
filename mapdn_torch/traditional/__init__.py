from mapdn_torch.traditional.droop import droop_control_law, droop_solve
from mapdn_torch.traditional.opf import opf_solve
