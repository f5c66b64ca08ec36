"""Import hygiene of the PyTorch port: neither its package nor
chip_smoke.py may import JAX or anything of the JAX package (only the
tests import both), every module imports on a machine that has only
PyTorch, numpy and the standard library, and its entry points must not
fall back to the CPU when CUDA is asked for and missing."""
import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "video_style_transfer_tpu")
# packages the machine with the card may lack: nothing may need them at
# import (the writers of data/video_io.py import theirs when called)
ABSENT = ("jax", "jaxlib", "safetensors", "regex", "imageio", "PIL", "cv2",
          "triton", "video_style_transfer_tpu")


def _port_files():
    pkg = ROOT / "video_style_transfer_tpu_torch"
    files = sorted(pkg.rglob("*.py")) + sorted(pkg.rglob("*.cu"))
    return files + [ROOT / "chip_smoke.py"]


def _python_files():
    return [p for p in _port_files() if p.suffix == ".py"]


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
                "lora/surgery.py", "cli/infer.py", "cli/verify_parity.py",
                "lora/interop.py", "ops/layer_norm.py", "csrc/layer_norm.cu",
                "data/tokenizer.py", "schedulers/dpm.py",
                "utils/safetensors_io.py", "utils/hf_convert.py",
                "utils/motion_convert.py", "utils/checkpoint.py",
                "utils/watermark.py", "data/video.py",
                "training/adam8bit.py", "utils/observability.py",
                "training/stage1.py", "training/prodigy.py",
                "cli/train_unziplora.py", "cli/cone_diagnostics.py"):
        assert f"video_style_transfer_tpu_torch/{mod}" in names
    assert len(names) > 30


@pytest.mark.parametrize("path", _python_files(),
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_imports(path):
    bad = [m for m in _imported_roots(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_nothing_names_the_jax_package_as_a_module():
    # prose may speak of "the JAX package"; no string or attribute may
    # spell its dotted module path
    for path in _port_files():
        text = path.read_text().replace("video_style_transfer_tpu_torch", "")
        assert "video_style_transfer_tpu." not in text, path
        assert "import video_style_transfer_tpu" not in text, path


def test_every_module_imports_without_optional_packages():
    """In a fresh interpreter where importing any of ABSENT fails, every
    module of the port and chip_smoke.py still import."""
    mods = ["chip_smoke"] + [
        p.relative_to(ROOT).with_suffix("").as_posix().replace("/", ".")
        for p in _python_files() if p.name != "chip_smoke.py"]
    mods = [m[:-len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    code = (
        "import importlib, importlib.abc, sys\n"
        f"ABSENT = {ABSENT!r}\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ABSENT and not name.startswith(\n"
        "                'video_style_transfer_tpu_torch'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ABSENT\n"
        "       and not m.startswith('video_style_transfer_tpu_torch')]\n"
        "assert not bad, bad\n"
        "print('imported', len(" + repr(mods) + "))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert f"imported {len(mods)}" in out.stdout


def _flags(parser):
    return {o for a in parser._actions for o in a.option_strings
            if o.startswith("--")} - {"--help"}


def test_stage1_cli_flags_match_jax():
    """The stage-1 CLI takes every flag of the JAX package's, and
    --device besides; the multi-process ones it refuses are among
    them."""
    from video_style_transfer_tpu.cli import train_unziplora as jcli
    from video_style_transfer_tpu_torch.cli import train_unziplora as tcli
    want = _flags(jcli.build_parser())
    got = _flags(tcli.build_parser())
    assert got - {"--device"} == want
    assert {f"--{f}" for f in tcli.NOT_PORTED} <= want


def test_stage1_cuda_device_without_cuda_raises(monkeypatch):
    from video_style_transfer_tpu_torch.cli import train_unziplora
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = train_unziplora.build_parser().parse_args(
        ["--smoke", "--instance_prompt", "a", "--content_forward_prompt",
         "b", "--style_forward_prompt", "c"])
    assert args.device == "cuda"
    with pytest.raises(SystemExit, match="CUDA is not available"):
        train_unziplora.train(args)


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


def test_image_cuda_device_without_cuda_raises(monkeypatch):
    from video_style_transfer_tpu_torch.cli import infer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = infer.build_parser().parse_args(["--smoke", "--prompt", "a dog"])
    assert args.device == "cuda"
    with pytest.raises(SystemExit, match="CUDA is not available"):
        infer.generate(args)
