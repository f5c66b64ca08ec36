"""The port's process-group start-up (parallel/distributed.py) and its
(data, frame) grid (parallel/mesh.py), without spawning: the contract
of the JAX package's init_distributed (tests/test_distributed.py) in
torch.distributed's terms. The flags, or torchrun's environment where a
flag is unset, describe the world; a world of one and a group that
already exists are no-ops; a topology that cannot start raises. The
collectives themselves run across processes in
test_torch_port_motion_sharded.py, _parallel_training.py and
_parallel_cli.py."""
import datetime
import time

import pytest
import torch
import torch.multiprocessing as mp

from video_style_transfer_tpu_torch.parallel import distributed, mesh

ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")
# what a stuck collective waits before it raises in a test worker
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=120)


def join_group(store, world, rank):
    """A test worker's gloo group on a file:// rendezvous (a fixed port
    would collide between test workers); a stuck collective raises."""
    import torch.distributed as dist
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank,
                            timeout=COLLECTIVE_TIMEOUT)


def spawn(fn, args, nprocs, timeout=600):
    """torch.multiprocessing.spawn with a deadline: a worker that fails
    raises here, and workers still running after `timeout` seconds are
    killed and the test fails."""
    ctx = mp.spawn(fn, args=args, nprocs=nprocs, join=False)
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"spawned workers still running after {timeout} s")


@pytest.fixture
def calls(monkeypatch):
    """init_process_group's calls, none made for real; no torchrun
    variables set."""
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    got = []

    def fake(backend, init_method=None, world_size=-1, rank=-1):
        got.append((backend, init_method, world_size, rank))

    monkeypatch.setattr(distributed.dist, "init_process_group", fake)
    return got


def test_world_of_one_is_a_no_op(calls):
    assert distributed.init_distributed() is False
    assert distributed.init_distributed(num_processes=1) is False
    assert distributed.init_distributed(process_id=0) is False
    assert calls == []
    assert distributed.world_size() == 1 and distributed.rank() == 0
    assert distributed.is_main_process()
    distributed.barrier("nothing to wait for")


def test_existing_group_is_a_no_op(calls, monkeypatch):
    monkeypatch.setattr(distributed.dist, "is_initialized", lambda: True)
    assert distributed.init_distributed("h:1", 2, 1) is False
    assert calls == []


def test_flags_describe_the_world(calls):
    assert distributed.init_distributed("node0:1234", 2, 1) is True
    assert calls == [("gloo", "tcp://node0:1234", 2, 1)]


def test_torchrun_environment(calls, monkeypatch):
    for k, v in (("MASTER_ADDR", "10.0.0.1"), ("MASTER_PORT", "29501"),
                 ("WORLD_SIZE", "4"), ("RANK", "3")):
        monkeypatch.setenv(k, v)
    assert distributed.init_distributed(device=torch.device("cuda", 0))
    assert calls == [("nccl", "tcp://10.0.0.1:29501", 4, 3)]


def test_flags_override_the_environment(calls, monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "8")
    monkeypatch.setenv("RANK", "7")
    monkeypatch.setenv("MASTER_ADDR", "elsewhere")
    distributed.init_distributed("here:5", 2, 0, backend="gloo",
                                 device="cuda")
    assert calls == [("gloo", "tcp://here:5", 2, 0)]


def test_url_addresses_pass_through(calls):
    distributed.init_distributed("file:///tmp/store", 2, 0)
    assert calls == [("gloo", "file:///tmp/store", 2, 0)]


@pytest.mark.parametrize("args,match", [
    ((None, 2, 0), "need --coordinator_address"),
    (("h:1", None, 0), "needs --num_processes"),
    (("h:1", 2, None), "needs --process_id"),
    (("h:1", 2, 2), "outside a world of 2"),
    ((None, None, 1), "in a world of one"),
])
def test_topologies_that_cannot_start_raise(calls, args, match):
    with pytest.raises(ValueError, match=match):
        distributed.init_distributed(*args)
    assert calls == []


def test_local_rank(monkeypatch):
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert distributed.local_rank() == 3
    monkeypatch.delenv("LOCAL_RANK")
    assert distributed.local_rank() == 0


def test_split_counts_and_shards():
    assert mesh.split_counts(8, 2) == (4, 4)
    assert mesh.split_counts(6, 4) == (2, 2, 1, 1)
    assert [mesh.shard_rows(6, 4, i) for i in range(4)] == [
        slice(0, 2), slice(2, 4), slice(4, 5), slice(5, 6)]
    with pytest.raises(ValueError):
        mesh.split_counts(3, 4)
    fs = mesh.FrameShard(None, (2, 2, 1, 1), 2)
    assert (fs.size, fs.frames, fs.start, fs.local, fs.even) == \
        (4, 6, 4, 1, False)
    assert fs.slice() == slice(4, 5)
    assert mesh.FrameShard(None, (4, 4), 1).even


def test_grid_places_ranks_row_major():
    g = mesh.Grid(data=2, frame=4, rank=6)
    assert (g.size, g.data_index, g.frame_index) == (8, 1, 2)
    assert g.data_rows(4) == slice(2, 4)
    fs = g.frame_shard(16)
    assert (fs.counts, fs.index, fs.slice()) == ((4,) * 4, 2, slice(8, 12))
    assert mesh.Grid(data=2, frame=1, rank=1).frame_shard(16) is None


def test_grid_model_axis_is_fastest():
    # --dp 2 --tp 2 over a frame axis of 2: rank 5 is data row 1, frame
    # 0, model rank 1; the ranks of a model group share rows and frames
    g = mesh.Grid(data=2, frame=2, rank=5, model=2)
    assert (g.size, g.data_index, g.frame_index, g.model_index) == \
        (8, 1, 0, 1)
    twin = mesh.Grid(data=2, frame=2, rank=4, model=2)
    assert g.positions(4, 6) == twin.positions(4, 6) == [
        12, 13, 14, 18, 19, 20]
    assert mesh.Grid(data=2, frame=1, rank=1).model_index == 0


@pytest.mark.parametrize("data,frame,rank,want", [
    (1, 1, 0, None),
    (2, 1, 1, [6, 7, 8, 9, 10, 11]),
    (1, 2, 1, [2, 5, 8, 11]),
    (2, 2, 2, [6, 7, 9, 10]),
])
def test_grid_positions_are_a_ranks_rows_and_frames(data, frame, rank,
                                                     want):
    # 4 rows (data 2: 2 a rank) of 3 frames (frame 2: frames 0-1 and 2)
    rows = 4
    g = mesh.Grid(data=data, frame=frame, rank=rank)
    got = g.positions(rows, 3)
    assert got == want
    if got is not None:
        flat = torch.arange(rows * 3).reshape(rows, 3)
        part = g.take({"x": flat}, frames=True)["x"].reshape(-1)
        assert part.tolist() == got


def test_grid_take_slices_rows_and_frames():
    g = mesh.Grid(data=2, frame=2, rank=3)
    tree = {"t": torch.arange(4), "noise": torch.arange(24).reshape(4, 6),
            "prior": {"t": torch.arange(4) * 10}}
    part = g.take(tree, frames=True)
    assert part["t"].tolist() == [2, 3]
    assert part["noise"].tolist() == [[15, 16, 17], [21, 22, 23]]
    assert part["prior"]["t"].tolist() == [20, 30]
    # without frames, only dim 0 is sliced
    assert g.take(tree)["noise"].shape == (2, 6)
    one = mesh.Grid(data=1, frame=1, rank=0)
    assert torch.equal(one.take(tree, frames=True)["noise"], tree["noise"])


def test_global_metrics_alone_are_unchanged():
    m = {"loss": torch.tensor(1.5)}
    assert distributed.global_metrics(m) is m


def test_create_mesh_in_a_world_of_one():
    g = mesh.create_mesh()
    assert (g.data, g.frame, g.rank) == (1, 1, 0)
    assert g.frame_shard(16) is None and g.data_rows(3) == slice(0, 3)
    with pytest.raises(ValueError, match="needs 2 processes"):
        mesh.create_mesh(frame=2)


def test_collectives_are_no_ops_alone():
    t = [torch.ones(3), torch.zeros(2, dtype=torch.float64)]
    distributed.all_reduce_tensors(t)
    assert t[0].tolist() == [1.0, 1.0, 1.0]
