"""The control: the reference in TF32 (the precision below the
configuration's float32) put in the program's place has to come out as not
correct under the cell's limits. TF32 exists only on the card, so this is
a card test (`python -m pytest -m gpu benchmark/tests`); benchmark/control.py
reads the same numbers at the cells' own size."""
import pytest
import torch

from benchmark import checks, harness
from benchmark.control import control_numbers
from benchmark.tests.small import small_spec

CELLS = ["train.garden-5m", "view.garden-5m-c3dgs", "finetune.garden-5m-c3dgs", "view.garden-5m"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name):
    if not torch.cuda.is_available():
        pytest.skip("the control is TF32, which only a CUDA card has")
    spec = small_spec(name, splats=200_000, width=640, height=416)
    numbers = control_numbers(spec, 77, torch.device("cuda"))["tf32"]
    assert not checks.judge(numbers, harness.load_cell(name)["limits"]), numbers
