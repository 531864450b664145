from mapdn_torch.parallel.mesh import (
    ShardedPGTrainer, init_process_group, lane_range, rank_device, shard_carry)
