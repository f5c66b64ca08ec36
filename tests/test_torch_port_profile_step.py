"""cli/profile_step.py's K4 table: `--k4` times K4 at every shape that
chip_smoke.py's sliced phases hold (d = 128-512), in bf16 and fp32, so
one flag compares a parent's K4 with a change's at every head dim."""
import ast
import pathlib

import pytest
import torch

from video_style_transfer_tpu_torch.cli import profile_step

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _smoke_sliced_shapes():
    """The (B, S, H, D) of chip_smoke.py's SLICED_SHAPES, read from its
    source (the script runs only where there is a card)."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "SLICED_SHAPES"
                for t in node.targets):
            return [shape for _, shape, _ in ast.literal_eval(node.value)]
    raise AssertionError("chip_smoke.py defines no SLICED_SHAPES")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k4_times_every_sliced_shape_of_the_smoke(dtype):
    shapes = _smoke_sliced_shapes()
    assert shapes and all(s[3] > 64 for s in shapes)
    timed = {(shape, dt) for _, shape, dt in profile_step.K4_SHAPES}
    for shape in shapes:
        assert (shape, dtype) in timed, (shape, dtype)
    # the cut-outs time the same rows
    cut = {(shape, dt) for _, shape, dt in profile_step.K4_SLICED_SHAPES}
    assert {(s, dtype) for s in shapes} <= cut
