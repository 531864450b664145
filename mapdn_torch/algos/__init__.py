from mapdn_torch.algos.base import AlgoState, MARLModel, Transition
from mapdn_torch.algos.mappo import MAPPO
