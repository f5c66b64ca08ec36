"""Data- and frame-parallel training steps of the port at 2 gloo ranks on
the CPU, each held against the one-process step of the same global
batch (the tiny configs of the CLIs' --smoke):

- stage 2 with --frame_parallel 2 (each rank 2 of the clip's 4 frames;
  the motion modules exchange frames);
- stage 2 with --data_parallel 2 (one clip a rank against batch 2);
- stage 1 with --data_parallel 2 (one row a rank against batch 2),
  three steps (reset, select, reset) through a column selection, its
  gradients scaled by 2^10 so that the cone crosses its 1e-5
  threshold.

The gradients each step applies (summed over the ranks), the losses and
the tensors after the update agree within 5e-5; the stage-1 selection
masks are equal on both ranks and equal to the one-process masks. One
spawn runs every case; the children import no JAX.
"""
import os

import numpy as np
import pytest
import torch
from test_torch_port_distributed import join_group, spawn

TOL = 5e-5
GRAD_SCALE = 2.0 ** 10
S2 = ["--smoke", "--device", "cpu", "--prompt", "a horse",
      "--max_train_steps", "1"]
S1 = ["--smoke", "--device", "cpu", "--instance_prompt", "a",
      "--content_forward_prompt", "b", "--style_forward_prompt", "c",
      "--num_instance_frames", "2", "--max_train_steps", "3",
      "--with_period_column_separation", "--sample_times", "2",
      "--checkpointing_steps", "100"]
CASES = {
    # name: (trainer, one-process flags, two-process flags)
    "stage2_frame": ("stage2", [], ["--frame_parallel", "2"]),
    "stage2_data": ("stage2", ["--train_batch_size", "2"],
                    ["--data_parallel", "2"]),
    "stage1_data": ("stage1", ["--train_batch_size", "2"],
                    ["--train_batch_size", "1", "--data_parallel", "2"]),
}


def _masks(tr):
    from video_style_transfer_tpu_torch.lora.surgery import tree_get
    return torch.cat([tree_get(tr.state.lora_state, p)[f"mask_{b}"]
                      .flatten() for p in tr.assignments
                      for b in ("content", "style")])


def run_case(name, flags, out_dir):
    """One case in this process (a rank of a group, or one process):
    {"grads": per step, "loss": per step, "tensors": after, "masks"}."""
    kind = CASES[name][0]
    grads = []
    if kind == "stage2":
        from video_style_transfer_tpu_torch.cli import train_animatediff
        args = train_animatediff.build_parser().parse_args(
            S2 + flags + ["--output_dir", out_dir])
        tr = train_animatediff.prepare(args)
        micro = train_animatediff.sample_micro_batches(tr, 0)
        m = tr.step(tr.params, micro, tr.generator,
                    on_grads=lambda g: grads.append([t.clone() for t in g]))
        return {"grads": grads, "loss": [float(m["loss"])],
                "tensors": [t.detach().clone() for _, t in tr.trainable],
                "masks": None}
    from video_style_transfer_tpu_torch.cli import train_unziplora

    def scaled(state, g):
        for v in g.values():
            v.mul_(GRAD_SCALE)
        grads.append([v.clone() for v in g.values()])

    args = train_unziplora.build_parser().parse_args(
        S1 + flags + ["--output_dir", out_dir])
    rep = {}
    tr = train_unziplora.train(args, rep, on_grads=scaled)
    return {"grads": grads, "loss": [l["loss"] for l in rep["losses"]],
            "tensors": [t.detach().clone() for _, t in
                        tr.optimizer.trainable],
            "masks": _masks(tr), "phase": rep["phase"]}


def _worker(rank, world, store, out_dir):
    import torch.distributed as dist

    join_group(store, world, rank)
    try:
        for name, (_, _, flags) in CASES.items():
            res = run_case(name, flags, os.path.join(out_dir, name))
            torch.save(res, os.path.join(out_dir, f"{name}_r{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    root = tmp_path_factory.mktemp("parallel_training")
    spawn(_worker, (2, str(root / "store"), str(root)), nprocs=2)
    return root


def _close(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=TOL,
                                   rtol=1e-5)


@pytest.mark.parametrize("name", list(CASES))
def test_parallel_step_matches_one_process(spawned, tmp_path, name):
    want = run_case(name, CASES[name][1], str(tmp_path))
    for rank in range(2):
        got = torch.load(spawned / f"{name}_r{rank}.pt")
        assert len(got["grads"]) == len(want["grads"]) >= 1
        for g, w in zip(got["grads"], want["grads"]):
            _close(g, w)
        np.testing.assert_allclose(got["loss"], want["loss"], atol=TOL,
                                   rtol=0)
        _close(got["tensors"], want["tensors"])
        if want["masks"] is not None:
            assert got["phase"] == want["phase"] == ["reset", "select",
                                                     "reset"]
            # the selection picked some columns, the same on every rank
            # and in one process
            assert 0 < int(want["masks"].sum()) < want["masks"].numel()
            assert torch.equal(got["masks"], want["masks"])


def test_stage1_masks_equal_on_every_rank(spawned):
    a, b = (torch.load(spawned / f"stage1_data_r{r}.pt") for r in range(2))
    assert torch.equal(a["masks"], b["masks"])
    assert int(a["masks"].sum()) > 0
    # the ranks made the same update from the same summed gradients
    for x, y in zip(a["tensors"], b["tensors"]):
        assert torch.equal(x, y)
