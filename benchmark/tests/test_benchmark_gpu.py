"""On the card: the control (the plain reference computed with TF32, the
nearest precision below the configuration's f32 with TF32 off, put in the
program's place) fails the b128 cells' limits, at the published widths on
fewer molecules.  Skips without a card."""
import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("name", ["gin_signnet_zinc.zinc_subset_b128",
                                  "gatedgcn_signnet_zinc.zinc_subset_b128"])
def test_the_tf32_control_is_not_correct(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists only there")
    import os
    from harness import check
    from harness.cell import make_inputs, reference_run
    from harness.spec import load_cell
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    cell = load_cell(root, name)
    cell.traffic = dict(cell.traffic, molecules=1000)
    dev = torch.device("cuda")
    failed = 0
    for seed in (11, 12, 13):
        graphs, params, buffers = make_inputs(cell, seed, dev)
        ref = reference_run(cell, graphs, params, buffers, seed, dev)
        ctl = reference_run(cell, graphs, params, buffers, seed, dev,
                            tf32=True)
        values = check.readings(ctl, ref)
        failed += not check.verdict(values, cell.limits)
    assert failed == 3
