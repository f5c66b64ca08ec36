"""The port's stage-1 CLI (cli/train_unziplora.py) on the CPU at the tiny
configs, its data and diagnostics against the JAX package's:

- one --smoke run with both kinds of prior data (the content class
  directory topped up by the base model, the style one given), the
  column separation through every phase, validation, --with_grad_record,
  a checkpoint, the export and --final_inference_check; then a run
  resumed from its checkpoint, its restored state bitwise as saved;
- its grad_records file under the JAX trainer's keys and (layers, out)
  shapes, read by the JAX package's cone_diagnostics and by the port's;
- load_image_dir against JAX's in each crop mode (equal arrays);
- the epoch and --scale_lr accounting, the never-selects warning, the
  refusal of each multi-process flag and of the reference's dead paths.
"""
import json
import os

import numpy as np
import pytest
import torch

from video_style_transfer_tpu.cli import cone_diagnostics as jcone
from video_style_transfer_tpu.config import UNetConfig as JUNetConfig
from video_style_transfer_tpu.data import video as jvideo
from video_style_transfer_tpu.lora import surgery as jsurgery
from video_style_transfer_tpu.models import unet as junet
from video_style_transfer_tpu_torch.cli import cone_diagnostics as tcone
from video_style_transfer_tpu_torch.cli import train_unziplora
from video_style_transfer_tpu_torch.data import video as tvideo
from video_style_transfer_tpu_torch.utils import checkpoint as ckpt

PROMPTS = ["--instance_prompt", "a sbu horse in szn style",
           "--content_forward_prompt", "a sbu horse",
           "--style_forward_prompt", "an image in szn style"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _args(*extra):
    return train_unziplora.build_parser().parse_args(
        PROMPTS + ["--smoke", "--device", "cpu", "--rank", "4"]
        + list(extra))


def _write_images(root, sizes, seed):
    from PIL import Image
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i, (w, h) in enumerate(sizes):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                        ).save(os.path.join(root, f"img{i}.png"))


def _tree_equal(a, b):
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and \
            torch.equal(a, b)
    if isinstance(a, dict):
        return set(a) == set(b) and all(_tree_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_tree_equal, a, b))
    return a == b


@pytest.fixture(scope="module")
def smoke_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("stage1")
    out = str(root / "out")
    style_dir = str(root / "style_class")
    _write_images(style_dir, [(20, 16), (16, 24)], seed=1)
    argv = ["--output_dir", out, "--num_instance_frames", "2",
            "--max_train_steps", "8", "--with_period_column_separation",
            "--sample_times", "2", "--checkpointing_steps", "4",
            "--validation_prompt", "a horse", "--validation_epochs", "8",
            "--validation_steps", "2", "--with_grad_record",
            "--final_inference_check", "--with_prior_preservation",
            "--class_data_dir", str(root / "content_class"),
            "--class_prompt", "a horse", "--num_class_images", "3",
            "--sample_batch_size", "2", "--prior_generation_steps", "2",
            "--class_data_dir_2", style_dir, "--class_prompt_2",
            "an image", "--prior_loss_weight", "1.0",
            "--prior_loss_weight_2", "0.5"]
    report = {}
    tr = train_unziplora.train(_args(*argv), report)
    # the resumed run: from checkpoint-4 to step 8, into its own directory
    restored = {}
    saved_path = os.path.join(out, "checkpoints", "checkpoint-4")

    def on_resume(t):
        saved = torch.load(os.path.join(saved_path, ckpt.STATE_FILE),
                           map_location="cpu", weights_only=True)
        live = ckpt.train_state(t.optimizer.trainable, t.optimizer,
                                t.state.step,
                                extra=train_unziplora.checkpoint_extra(
                                    t.state))
        restored.update(step=t.state.step, equal={
            k: _tree_equal(live[k], saved[k]) for k in (
                "trainable", "optimizer_state", "extra")})

    out_b = str(root / "resumed")
    resumed = {}
    train_unziplora.train(_args(*(argv[2:] + [
        "--output_dir", out_b, "--resume_from_checkpoint", saved_path])),
        resumed, on_setup=on_resume)
    return {"root": root, "out": out, "out_b": out_b, "report": report,
            "tr": tr, "restored": restored, "resumed": resumed}


def test_smoke_run_every_phase_and_outputs(smoke_run):
    rep, out = smoke_run["report"], smoke_run["out"]
    assert rep["phase"] == ["reset", "sampling", "select", "zeroout"] * 2
    assert all(np.isfinite(v) for l in rep["losses"] for v in l.values())
    assert {"loss_prior_content", "loss_prior_style"} <= set(rep["losses"][0])
    # the content class directory was topped up to 3 images; both prior
    # branches took their images
    made = sorted(os.listdir(os.path.join(smoke_run["root"],
                                          "content_class")))
    assert len(made) == 3 and all(n.endswith(".jpg") for n in made)
    assert set(smoke_run["tr"].priors) == {"content", "style"}
    assert rep["selected_columns"][2]["content"] > 0
    assert sorted(os.listdir(os.path.join(out, "checkpoints"))) == [
        "checkpoint-4", "checkpoint-8"]
    assert sorted(os.listdir(os.path.join(out, "validation"))) == [
        "step8_both.png", "step8_content.png", "step8_style.png"]
    assert sorted(os.listdir(os.path.join(out, "grad_records"))) == [
        "step3.npz", "step7.npz"]
    assert os.path.isfile(os.path.join(out, "final_check_both.png"))
    for f in rep["artifacts"].values():
        assert os.path.isfile(f)
    with open(os.path.join(out, "metrics.jsonl")) as f:
        lines = [json.loads(x) for x in f]
    scalars = [ln for ln in lines if "loss" in ln]
    assert [ln["step"] for ln in scalars] == [0, 7]
    assert any(k.endswith("_norm") for k in scalars[0])
    assert any(k.endswith("_merge") for k in scalars[0])


def test_resume_restores_bitwise(smoke_run):
    assert smoke_run["restored"]["step"] == 4
    assert smoke_run["restored"]["equal"] == {
        "trainable": True, "optimizer_state": True, "extra": True}
    assert smoke_run["resumed"]["phase"] == smoke_run["report"]["phase"][4:]


def test_grad_records_use_jax_keys_and_shapes(smoke_run):
    import jax
    tree = jax.eval_shape(lambda k: junet.init_unet(k, JUNetConfig.tiny()),
                          jax.random.PRNGKey(0))
    want = {}
    for path in jsurgery.layer_assignments(tree, {}, {},
                                           layers_per_block=1):
        kernel = jsurgery.tree_get(tree, path)["kernel"]
        name = ".".join(str(x) for x in path)
        for b in ("content", "style"):
            want[f"{name}.score_{b}"] = (kernel.shape[0], kernel.shape[2])
    with np.load(os.path.join(smoke_run["out"], "grad_records",
                              "step3.npz")) as f:
        got = {k: f[k].shape for k in f.files}
        assert all(f[k].dtype == np.float32 for k in f.files)
        assert any(f[k].any() for k in f.files)
    assert got == want


def test_cone_diagnostics_read_grad_records(smoke_run, tmp_path):
    rec = os.path.join(smoke_run["out"], "grad_records", "step3.npz")
    with np.load(rec) as f:
        layers = sorted(f.files)[:4]   # four strips keep the drawing quick
    for name, cli in (("jax", jcone), ("port", tcone)):
        out = str(tmp_path / f"{name}.png")
        assert cli.main(["--scores", rec, "--output", out,
                         "--layers", *layers]) == out
        assert os.path.getsize(out) > 0
    # the weights-and-gradients form, on a pair of the port's files
    rng = np.random.default_rng(0)
    w = {"a": rng.standard_normal((6, 5)).astype(np.float32)}
    g = {"a": rng.standard_normal((6, 5)).astype(np.float32) * 1e-5}
    np.savez(tmp_path / "w.npz", **w)
    np.savez(tmp_path / "g.npz", **g)
    out = str(tmp_path / "wg.png")
    assert tcone.main(["--weights", str(tmp_path / "w.npz"), "--grads",
                       str(tmp_path / "g.npz"), "--output", out]) == out


@pytest.mark.parametrize("crop", ["squish", "center", "random"])
def test_load_image_dir_matches_jax(tmp_path, crop):
    _write_images(str(tmp_path), [(40, 24), (24, 40), (30, 30)], seed=2)
    want = jvideo.load_image_dir(str(tmp_path), 16, crop=crop, seed=3)
    got = tvideo.load_image_dir(str(tmp_path), 16, crop=crop, seed=3)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_epoch_and_scale_lr_accounting():
    args = _args("--num_instance_frames", "3", "--train_batch_size", "2",
                 "--num_train_epochs", "2", "--repeats", "2",
                 "--gradient_accumulation_steps", "2", "--scale_lr")
    tr = train_unziplora.prepare(args)
    # 6 items, 3 batches an epoch, 2 updates an epoch
    assert tr.max_steps == args.max_train_steps == 4
    assert tr.sep.steps_per_epoch == 2
    assert args.content_learning_rate == pytest.approx(5e-5 * 4)
    assert args.weight_learning_rate == pytest.approx(5e-3 * 4)
    assert len(train_unziplora.micro_batches(tr, 2)) == 2


def test_warns_when_selection_never_happens(capsys):
    train_unziplora.prepare(_args("--num_instance_frames", "4",
                                  "--max_train_steps", "6",
                                  "--sample_times", "3",
                                  "--with_period_column_separation"))
    assert "column separation will never select" in capsys.readouterr().out


@pytest.mark.parametrize("flag,value", [
    ("--data_parallel", "1"), ("--coordinator_address", "localhost:1"),
    ("--num_processes", "2"), ("--process_id", "0")])
def test_refuses_unported_flags(flag, value):
    with pytest.raises(SystemExit, match="not ported yet"):
        train_unziplora.prepare(_args(flag, value))


@pytest.mark.parametrize("flag", [["--train_text_encoder"],
                                  ["--dataset_name", "x"]])
def test_reference_dead_paths_raise(flag):
    with pytest.raises(NotImplementedError):
        train_unziplora.prepare(_args(*flag))


def test_profiler_trace_hooks(tmp_path):
    from video_style_transfer_tpu_torch.utils import observability as tobs
    tobs.start_profiler_trace(str(tmp_path))
    with pytest.raises(RuntimeError):
        tobs.start_profiler_trace(str(tmp_path))
    torch.ones(8).sum()
    path = tobs.stop_profiler_trace()
    with open(path) as f:
        assert "traceEvents" in json.load(f)
