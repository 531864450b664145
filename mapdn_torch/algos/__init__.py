from mapdn_torch.algos.base import AlgoState, MARLModel, Transition
from mapdn_torch.algos.mappo import MAPPO
from mapdn_torch.algos.registry import MODEL_REGISTRY, make_model
