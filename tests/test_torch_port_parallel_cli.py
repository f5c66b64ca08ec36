"""The port's CLIs in two gloo processes on the CPU, each through its
``main`` with the coordinator flags (a ``file://`` rendezvous in a temp
directory: a fixed port would collide between test workers):

- ``infer_video --smoke --frame_parallel 2`` gives the one-process
  video (latents within 1e-4: the GroupNorm statistics and the frame
  exchange sum in another order; uint8 frames within one level), and
  only process 0 writes it;
- ``infer --smoke --dp 2`` over three seeds (the last round padded with
  a repeat) gives the one-process images bitwise, and only process 0
  writes them;
- ``train_animatediff --smoke --frame_parallel 2`` writes a checkpoint
  at step 1 from process 0 alone (one metrics line a logged step), and
  a second two-process run resumes from it on both processes to equal
  tensors, bitwise.

One spawn runs every case; the children import no JAX.
"""
import json
import os

import numpy as np
import pytest
import torch
from test_torch_port_distributed import spawn

VIDEO = ["--smoke", "--device", "cpu", "--prompt", "a horse", "--modes",
         "both"]
IMAGE = ["--smoke", "--device", "cpu", "--prompt", "a dog", "--mode",
         "both", "--seeds", "0", "5", "7"]
TRAIN = ["--smoke", "--device", "cpu", "--prompt", "a horse",
         "--frame_parallel", "2", "--checkpointing_steps", "1"]


def _flags(store, rank):
    return ["--coordinator_address", f"file://{store}", "--num_processes",
            "2", "--process_id", str(rank)]


def _captured(module):
    """Wrap module.generate to keep its outputs and report."""
    got = {}
    orig = module.generate

    def generate(args, report=None):
        report = {} if report is None else report
        got["outs"] = orig(args, report)
        got["report"] = report
        return got["outs"]

    module.generate = generate
    return got


def _worker(rank, root):
    import torch.distributed as dist

    from video_style_transfer_tpu_torch.cli import (
        infer, infer_video, train_animatediff)

    torch.set_num_threads(2)
    res = {}
    # each CLI joins the group its flags describe; the others find it
    got = _captured(infer_video)
    res["video_paths"] = infer_video.main(
        VIDEO + ["--frame_parallel", "2", "--output_dir",
                 os.path.join(root, f"video_r{rank}")]
        + _flags(os.path.join(root, "store"), rank))
    res["video"] = got["outs"]["both"]
    res["latents"] = got["report"]["both"]["latents"]
    res["frame_range"] = got["report"]["both"]["frame_range"]
    got = _captured(infer)
    res["image_paths"] = infer.main(
        IMAGE + ["--dp", "2", "--output_dir",
                 os.path.join(root, f"image_r{rank}")])
    res["images"] = got["outs"]
    res["image_jobs"] = sorted(got["report"]["images"])
    run = os.path.join(root, "train")
    for steps, resume in ((1, []),
                          (2, ["--resume_from_checkpoint", "latest"])):
        tr = train_animatediff.train(train_animatediff.build_parser()
                                     .parse_args(TRAIN + resume + [
                                         "--max_train_steps", str(steps),
                                         "--output_dir", run]))
        res.setdefault("train", []).append(
            {"start": tr.start, "tensors": [t.detach().clone()
                                            for _, t in tr.trainable]})
    torch.save(res, os.path.join(root, f"r{rank}.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    root = tmp_path_factory.mktemp("parallel_cli")
    spawn(_worker, (str(root),), nprocs=2)
    # the children pickled numpy frames beside their tensors
    return root, [torch.load(root / f"r{r}.pt", weights_only=False)
                  for r in range(2)]


def test_frame_parallel_video_matches_one_process(spawned):
    from video_style_transfer_tpu_torch.cli import infer_video
    root, ranks = spawned
    report = {}
    want = infer_video.generate(infer_video.build_parser().parse_args(
        VIDEO), report)["both"]
    lat = report["both"]["latents"].numpy()
    assert [r["frame_range"] for r in ranks] == [(0, 2), (2, 4)]
    for r in ranks:
        a, b = r["frame_range"]
        np.testing.assert_allclose(r["latents"].numpy(), lat[a:b],
                                   atol=1e-4, rtol=0)
        assert r["video"].shape == want.shape
        assert np.abs(r["video"].astype(int) - want.astype(int)).max() <= 1
    # process 0 wrote the video (an mp4, or a gif without ffmpeg),
    # process 1 nothing
    (path,) = ranks[0]["video_paths"]
    assert os.path.basename(path).startswith("both.")
    assert os.listdir(root / "video_r0") == [os.path.basename(path)]
    assert ranks[1]["video_paths"] == []
    assert not os.path.exists(root / "video_r1")


def test_dp_images_match_one_process(spawned):
    from video_style_transfer_tpu_torch.cli import infer
    root, ranks = spawned
    want = infer.generate(infer.build_parser().parse_args(IMAGE))
    names = ["both_seed0", "both_seed5", "both_seed7"]
    # jobs by rank: seeds 0 and 7 on process 0, 5 on process 1 (the
    # last round's repeat of seed 7 on process 1 is dropped)
    assert ranks[0]["image_jobs"] == ["both_seed0", "both_seed7"]
    assert ranks[1]["image_jobs"] == ["both_seed5"]
    for r in ranks:
        assert sorted(r["images"]) == names
        for k in names:
            np.testing.assert_array_equal(r["images"][k], want[k])
    assert sorted(os.listdir(root / "image_r0")) == [f"{n}.png"
                                                     for n in names]
    assert ranks[1]["image_paths"] == []
    assert not os.path.exists(root / "image_r1")


def test_frame_parallel_train_checkpoint_and_resume(spawned):
    root, ranks = spawned
    ckpts = sorted(os.listdir(root / "train" / "checkpoints"))
    assert ckpts == ["checkpoint-1", "checkpoint-2"]
    # one metrics line a logged step, from process 0 alone
    with open(root / "train" / "metrics.jsonl") as f:
        assert [json.loads(ln)["step"] for ln in f] == [0, 1]
    for r in ranks:
        assert [run["start"] for run in r["train"]] == [0, 1]
    # both processes resumed from process 0's checkpoint and made the
    # same update
    for a, b in zip(ranks[0]["train"][1]["tensors"],
                    ranks[1]["train"][1]["tensors"]):
        assert torch.equal(a, b)
    state = torch.load(root / "train" / "checkpoints" / "checkpoint-1"
                       / "state.pt")
    assert state["step"] == 1
    for a, b in zip(ranks[0]["train"][0]["tensors"],
                    state["trainable"].values()):
        assert torch.equal(a, b)
