from mapdn_torch.envs.voltage_control import (
    EnvConfig, EnvState, StepOutput, VoltageControlEnv, make_env)
