"""On the card: the control (the plain reference computed in TF32, the
next precision below the configurations' float32 with TF32 off, put in the
program's place) fails each cell's check at the cell's own size, and the
program passes it on the same seed. Run there with
``python -m pytest portbench/tests -q -m gpu``; skips without a card."""
import pytest
import torch

import calibrate
from harness import compare, manifest

pytestmark = pytest.mark.gpu
SEED = 2**31 + 4242


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("workload", [w["name"] for w in manifest.load()["workloads"]])
def test_the_control_fails_and_the_program_passes(cuda, workload):
    ctx = calibrate.context(workload, SEED, cuda)
    train = ctx.mix["driver"] == "train"
    got = (calibrate.train_readings if train else calibrate.eval_readings)(ctx)
    assert compare.verdict(got["program"], ctx.limits)[0], got["program"]
    control = (calibrate.train_control if train else calibrate.eval_control)(ctx)
    assert not compare.verdict(control, ctx.limits)[0], control
