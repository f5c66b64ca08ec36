"""Import hygiene of the PyTorch port: neither its package nor
chip_smoke.py may import JAX or anything of the JAX package (only the
tests import both), and its entry points must not fall back to the CPU
when CUDA is asked for and missing."""
import ast
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "video_style_transfer_tpu")


def _port_files():
    files = sorted((ROOT / "video_style_transfer_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module


def test_port_files_exist():
    names = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    assert "chip_smoke.py" in names
    assert "video_style_transfer_tpu_torch/cli/infer_video.py" in names
    for mod in ("cli/train_animatediff.py", "training/stage2.py",
                "training/schedules.py", "lora/unzip.py", "lora/temporal.py",
                "lora/surgery.py"):
        assert f"video_style_transfer_tpu_torch/{mod}" in names
    assert len(names) > 20


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_imports(path):
    bad = [m for m in _imported_roots(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_cuda_device_without_cuda_raises(monkeypatch):
    from video_style_transfer_tpu_torch.cli import infer_video
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = infer_video.build_parser().parse_args(
        ["--smoke", "--prompt", "a horse", "--device", "cuda"])
    with pytest.raises(SystemExit, match="CUDA is not available"):
        infer_video.generate(args)


def test_train_cuda_device_without_cuda_raises(monkeypatch):
    from video_style_transfer_tpu_torch.cli import train_animatediff
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = train_animatediff.build_parser().parse_args(
        ["--smoke", "--prompt", "a horse", "--device", "cuda"])
    with pytest.raises(SystemExit, match="CUDA is not available"):
        train_animatediff.train(args)
