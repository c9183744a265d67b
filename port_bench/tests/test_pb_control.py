"""The control on a card: the reference in TF32 put in the program's place
must fail the limits, at a small size.  Runs where a CUDA device is,
skips elsewhere."""

import pytest
import torch

from port_bench import check, control
from port_bench.tests import tiny


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: TF32 exists only on the card")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["gcn2", "pna"])
def test_tf32_control_fails(tmp_path, cuda, model):
    # without dropout, as the cells run: a fused epoch draws its masks
    # inside the capture and the replays, where the check cannot see them
    b, name = tiny.bench(str(tmp_path), model, dropout=0.0, drop_input=False)
    r = control.readings(b, f"{name}.gas", 7, ["tf32"], cuda)
    assert check.verdict(r["program"], tiny.LIMITS[model]), r["program"]
    assert not check.verdict(r["tf32"], tiny.LIMITS[model]), r["tf32"]
