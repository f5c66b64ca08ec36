"""The comparison that decides ``correct``: the reference agrees with
the program's plain CPU path at the tiny config, the control (the
reference in the lower precision, in the program's place) reads above
the limits, and a run with the timed path broken underneath comes out
not correct, once for each fault a serving cell can have. (The exchange
between chips is not among them: every serving cell runs on one chip.)"""
from __future__ import annotations

import pytest
import torch

from bench_port.run import run_cell
from bench_port.tests.tiny import LIMITS


def _driver(reg, cell, seed=5):
    cell_entry = reg.cell(cell)
    d = reg.driver("serve").Driver(
        reg.config(cell_entry["config"]), reg.traffic(cell_entry["traffic"]),
        reg.cell_spec(cell), seed, "cpu", False)
    d.setup()
    d.request(0)
    d.release()
    return d


@pytest.mark.parametrize("cell", ["tiny_video", "tiny_image"])
def test_reference_agrees_with_the_plain_cpu_path(tiny_registry, cell):
    r = _driver(tiny_registry, cell).check()
    assert r["start"] == 0 and r["euler"] == 0 and r["frames"] == 0
    assert r["eps"] < 1e-4 and r["decode"] < 1e-5


@pytest.mark.parametrize("cell", ["tiny_video", "tiny_image"])
def test_the_fp8_control_fails(tiny_registry, cell):
    r = _driver(tiny_registry, cell).check(fp8=True)
    assert r["eps"] > 30 * LIMITS["eps"]


def _unchanged_step(monkeypatch):
    from video_style_transfer_tpu_torch.pipelines import sampling
    monkeypatch.setattr(sampling, "euler_step",
                        lambda sample, eps, sigma, sigma_next: sample)


def _half_batch(monkeypatch):
    from video_style_transfer_tpu_torch.pipelines import sampling
    real = sampling.unet_apply

    def half(*args, **kw):
        out = real(*args, **kw)
        n = out.shape[0] // 2
        return torch.cat([out[:n], out[:n]])
    monkeypatch.setattr(sampling, "unet_apply", half)


def _altered_answer(monkeypatch):
    from video_style_transfer_tpu_torch.pipelines import image
    real = image.vae_decode

    def altered(params, cfg, z):
        out = real(params, cfg, z).clone()
        out[0, 0, 0, 0] += 0.5
        return out
    monkeypatch.setattr(image, "vae_decode", altered)


@pytest.mark.parametrize("fault, reading", [
    (_unchanged_step, "euler"), (_half_batch, "eps"),
    (_altered_answer, "decode")])
@pytest.mark.parametrize("cell", ["tiny_video", "tiny_image"])
def test_a_broken_timed_path_is_not_correct(tiny_registry, monkeypatch,
                                            cell, fault, reading):
    fault(monkeypatch)
    result = run_cell(tiny_registry, cell, 77, 0.0, False, device="cpu")
    assert not result["correct"]
    c = result["checks"][reading]
    assert c["value"] > c["limit"]


@pytest.mark.cuda
def test_a_cell_runs_correct_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from pathlib import Path

    from bench_port.registry import Registry
    reg = Registry(Path(__file__).resolve().parent.parent.parent)
    result = run_cell(reg, "image_both_4seeds_1024", 2 ** 31 + 101, 1.0,
                      False)
    assert result["correct"], result["checks"]
