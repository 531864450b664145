"""The control: the reference in float32 with TF32 matmuls in the
program's place must come out not correct under each cell's limits.  TF32
exists only on the card, so this runs there (``cuda``), at a size a test
run holds; ``perfbench/control.py`` reads it at the cells' own sizes."""
import pytest
import torch

from perfbench import check, control, spec

import tiny


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["case33_mappo.train512", "case33_mappo.train8192",
                                  "case322_mappo.train4096", "case33_mappo.eval1"])
def test_control_fails(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: TF32 matmuls exist only on the card")
    if name.endswith("eval1"):
        # the cell's own check, every day of a run's window: on one day the
        # control can stay inside (PERF.md)
        cell, seconds = spec.cell(name), spec.benchmark()["run_seconds"]
    elif name.endswith("train512"):
        # the cell's own size: at 256 lanes and 8-step windows a sound
        # run's worst gradient leaf reads above the cell's limit (PERF.md)
        cell, seconds = spec.cell(name), 0.0
    else:
        cell, seconds = tiny.cell(name), 0.0
        cell["traffic"]["lanes"] = 256
        cell["check"]["check"]["pairs"] = 512
    out = {side: nums for side, nums, _ in
           control.readings(cell, 424242, torch.device("cuda"), control=True, seconds=seconds)}
    sound, rows = check.judge(out[next(k for k in out if k != "control")], cell["check"]["limits"])
    failed, control_rows = check.judge(out["control"], cell["check"]["limits"])
    assert sound, [r for r in rows if r[2] is not None and not r[1] <= r[2]]
    assert not failed, control_rows
