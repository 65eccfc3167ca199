"""Each cell's control, the plain reference at the nearest precision below
the configuration's put in the program's place, comes out not correct: TF32
for fig2's float32, fp8 for granite's bfloat16.  At the smoke widths, on
the CPU and on the card."""

import pytest
import torch

from gpubench import bench

CONTROLS = [("sim-smoke", "tf32"), ("train-smoke", "fp8"), ("prefill-smoke", "fp8")]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell,precision", CONTROLS)
def test_control_is_not_correct_on_the_cpu(smoke_root, cell, precision):
    line = bench.run_cell(cell, 2**31 + 5, 0.2, False, root=smoke_root, device="cpu", control=precision)
    assert not line["correct"], line["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell,precision", CONTROLS)
def test_control_is_not_correct_on_the_card(cuda, smoke_root, cell, precision):
    line = bench.run_cell(cell, 2**31 + 6, 0.5, False, root=smoke_root, control=precision)
    assert not line["correct"], line["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["sim-smoke", "train-smoke", "prefill-smoke"])
def test_smoke_cells_are_correct_on_the_card(cuda, smoke_root, cell):
    line = bench.run_cell(cell, 2**31 + 7, 0.5, True, root=smoke_root)
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["busy_s"] > 0
