"""The port's 8-bit AdamW, training checkpoints and resume held against
the JAX package: training/adam8bit.py against JAX's adamw8bit chain (codes
and scales equal, updates within 1e-6), utils/checkpoint.py against JAX's
commit-then-prune rotation and latest-checkpoint rule, and the stage-2
CLI resumed from its own checkpoint against the run it was saved from
(bitwise)."""
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from video_style_transfer_tpu.training import stage2 as jstage2
from video_style_transfer_tpu.utils import checkpoint as jckpt
from video_style_transfer_tpu.utils import observability as jobs
from video_style_transfer_tpu_torch.cli import train_animatediff
from video_style_transfer_tpu_torch.training import adam8bit as tadam8
from video_style_transfer_tpu_torch.training import stage2 as tstage2
from video_style_transfer_tpu_torch.utils import checkpoint as tckpt
from video_style_transfer_tpu_torch.utils import observability as tobs

cv2 = pytest.importorskip("cv2")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The tiny trainer's ops are too small to share among threads; one
    thread a test process keeps it quick while the suite's workers share
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ 8-bit AdamW

def _jax_8bit_state(st):
    """The JAX adamw8bit chain's moment leaves (multi_transform ->
    chain(clip, chain(scale_by_adam8bit, ...)))."""
    inner = st.inner_states["train"].inner_state
    adam = inner[1][0]
    return adam.m, adam.v


def _grads(step, shapes):
    rng = np.random.default_rng(100 + step)
    out = []
    for shape in shapes:
        g = rng.standard_normal(shape).astype(np.float32) * 1e-2
        if len(shape) == 2 and shape[0] * shape[1] >= 4096:
            g.reshape(-1)[300] = 50.0      # an outlier in block 1
            g.reshape(-1)[600:700] = 0.0   # zeros inside block 2
        out.append(g)
    return out


@pytest.mark.parametrize("clipped", [False, True])
def test_adamw8bit_three_steps_match_jax(clipped):
    """One tensor above min_8bit_size (24 blocks, one holding an outlier
    and one a run of zeros) and one below. Unclipped, the codes and scales
    equal JAX's at every step. With the second step's gradients clipped
    the codes still equal JAX's, but the scales may differ in their last
    bits (1e-6 relative): the global norm is a sum whose order differs
    between XLA and torch, so the clipped gradients do (the clip itself
    is held to optax by the fp32 AdamW tests)."""
    shapes = [(64, 96), (8, 16)]
    rng = np.random.default_rng(7)
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    norms = [np.sqrt(sum(float((g * g).sum()) for g in _grads(i, shapes)))
             for i in range(3)]
    kw = dict(lr=1e-3, total_steps=6, warmup=1, weight_decay=0.05,
              max_grad_norm=1.5 * max(norms))
    jopt = jstage2.make_optimizer([True, True], optimizer="adamw8bit", **kw)
    jparams = [jnp.asarray(p) for p in params]
    jst = jopt.init(jparams)
    tparams = [torch.from_numpy(p.copy()) for p in params]
    topt = tstage2.make_optimizer(tparams, optimizer="adamw8bit", **kw)
    assert isinstance(topt, tadam8.AdamW8bit)
    update = jax.jit(jopt.update)
    for i in range(3):
        clip = clipped and i == 1
        gs = [g * (40.0 if clip else 1.0) for g in _grads(i, shapes)]
        assert (np.sqrt(sum(float((g * g).sum()) for g in gs))
                > kw["max_grad_norm"]) == clip
        upd, jst = update([jnp.asarray(g) for g in gs], jst, jparams)
        jparams = [p + u for p, u in zip(jparams, upd)]
        topt.step([torch.from_numpy(g) for g in gs])
        for p, want in zip(tparams, jparams):
            np.testing.assert_allclose(p.numpy(), np.asarray(want),
                                       atol=1e-6, rtol=0,
                                       err_msg=f"step {i}")
        jm, jv = _jax_8bit_state(jst)
        # the large tensor's moments as codes and scales
        for name, got, want in (("m", topt.m[0], jm[0]),
                                ("v", topt.v[0], jv[0])):
            q_got, q_want = got["q"].numpy(), np.asarray(want["q"])
            assert q_got.dtype == q_want.dtype
            off = np.abs(q_got.astype(int) - q_want.astype(int))
            assert off.max() == 0, (
                f"step {i} {name}: {int((off > 0).sum())} codes differ "
                f"from JAX's, by at most {off.max()}")
            s_got, s_want = got["s"].numpy(), np.asarray(want["s"])
            if clipped and i >= 1:
                np.testing.assert_allclose(s_got, s_want, rtol=1e-6,
                                           atol=0)
            else:
                np.testing.assert_array_equal(s_got, s_want)
        # the small tensor keeps fp32 moments, held to their largest
        # entry (v goes as g², so twice the clipped gradients' relative
        # difference)
        for got, want, tol in ((topt.m[1], jm[1], 1e-6),
                               (topt.v[1], jv[1], 2e-6)):
            want = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=tol * np.abs(want).max())
    assert topt.m[0]["q"].dtype == torch.int8
    assert topt.v[0]["q"].dtype == torch.uint8
    # the outlier does not erase the sqrt(v) of its block's other
    # entries, ~1e-4 of it (no nonzero moment decodes to zero); zero
    # moments stay exactly zero
    v = tadam8.dequantize_sqrtv(topt.v[0], shapes[0]).reshape(-1)
    assert (v[256:512] > 0).all() and float(v[300]) > 1e3 * float(v[301])
    assert (v[600:700] == 0).all()


def test_sqrtv_code_boundaries():
    """Each code's centre decodes to itself; values just across a
    rounding boundary take the neighbouring codes; the floor clamps up."""
    codes = torch.arange(1, 256)
    r = torch.from_numpy(tadam8._VALUES[1:])
    st = tadam8.quantize_sqrtv(torch.cat([r, torch.zeros(1)]))
    assert torch.equal(st["q"][0, :255].long(), codes)
    assert st["q"][0, 255] == 0
    bounds = torch.from_numpy(tadam8._f32_at_least(tadam8._BOUNDS))
    below = torch.nextafter(bounds, torch.zeros(()))
    for x, want in ((bounds, codes[1:]), (below, codes[:-1])):
        got = tadam8.quantize_sqrtv(torch.cat([x, torch.ones(1)]))["q"]
        assert torch.equal(got.reshape(-1)[:254].long(), want)
    tiny = tadam8.quantize_sqrtv(torch.tensor([1.0, 1e-9, 0.0]))
    assert tiny["q"][0, :3].tolist() == [255, 1, 0]


@pytest.mark.parametrize("kind", ["adamw", "adamw8bit"])
def test_optimizer_state_dict_roundtrip(kind):
    ps = [torch.randn(64, 80), torch.randn(5)]
    opt = tstage2.make_optimizer(ps, optimizer=kind, warmup=0, lr=1e-2)
    for _ in range(2):
        opt.step([torch.randn_like(p) for p in ps])
    sd = opt.state_dict()
    fresh = tstage2.make_optimizer([p.clone() for p in ps], optimizer=kind)
    fresh.load_state_dict(sd)
    assert fresh.count == opt.count == 2
    _assert_tree_equal(fresh.state_dict(), sd)
    # a state of other shapes raises and leaves the optimizer as it was
    other = tstage2.make_optimizer([torch.zeros(64, 81), torch.zeros(5)],
                                   optimizer=kind)
    before = other.state_dict()
    with pytest.raises(ValueError):
        other.load_state_dict(sd)
    _assert_tree_equal(other.state_dict(), before)


def test_8bit_state_smaller_than_fp32():
    ps = [torch.randn(320, 320), torch.randn(1280, 32), torch.randn(320)]
    opt8 = tstage2.make_optimizer(ps, optimizer="adamw8bit")
    fp32 = sum(2 * p.numel() * 4 for p in ps)
    # codes 1 byte + one fp32 scale per 256 a moment; the bias fp32
    assert opt8.state_bytes() == (2 * (320 * 320 + 1280 * 32) * (1 + 4 / 256)
                                  + 2 * 320 * 4)
    assert opt8.state_bytes() < 0.3 * fp32


def _assert_tree_equal(a, b):
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
    elif isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_tree_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_tree_equal(x, y)
    else:
        assert a == b


# ------------------------------------------------------------ checkpoints

def _trainer(shapes=((4, 6), (3,)), dtype=torch.float32, kind="adamw"):
    ts = [(("blk", i, "w"), torch.randn(s).to(dtype))
          for i, s in enumerate(shapes)]
    return ts, tstage2.make_optimizer([t for _, t in ts], optimizer=kind)


def test_latest_checkpoint_agrees_with_jax(tmp_path):
    assert tckpt.latest_checkpoint(str(tmp_path / "none")) is None
    assert jckpt.latest_checkpoint(str(tmp_path / "none")) is None
    assert tckpt.latest_checkpoint(str(tmp_path)) is None
    for name in ("checkpoint-3", "checkpoint-10", "checkpoint-9.tmp",
                 "checkpoint-12.tmp", "checkpoint-20.orbax-checkpoint-tmp-1",
                 "checkpoint-x", "other"):
        os.makedirs(tmp_path / name)
    got = tckpt.latest_checkpoint(str(tmp_path))
    assert got == jckpt.latest_checkpoint(str(tmp_path))
    assert got == str(tmp_path / "checkpoint-10")


def test_rotation(tmp_path):
    ts, opt = _trainer()
    for step in (1, 2, 3):
        tckpt.save_checkpoint(str(tmp_path), tckpt.train_state(ts, opt, step),
                              step, total_limit=2)
    names = sorted(os.listdir(tmp_path))
    assert names == ["checkpoint-2", "checkpoint-3"]


def test_kill_mid_save_never_loses_the_only_checkpoint(tmp_path,
                                                       monkeypatch):
    """A save that dies mid-write leaves the previous checkpoint on disk
    and restorable, even at total_limit=1: pruning follows the commit."""
    ts, opt = _trainer()
    saved = [t.clone() for _, t in ts]
    tckpt.save_checkpoint(str(tmp_path), tckpt.train_state(ts, opt, 1), 1,
                          total_limit=1)

    class Boom(RuntimeError):
        pass

    def dying_save(obj, f):
        with open(f, "wb") as fh:
            fh.write(b"half a checkpoint")
        raise Boom()

    monkeypatch.setattr(tckpt.torch, "save", dying_save)
    with pytest.raises(Boom):
        tckpt.save_checkpoint(str(tmp_path), tckpt.train_state(ts, opt, 2),
                              2, total_limit=1)
    monkeypatch.undo()
    assert sorted(os.listdir(tmp_path)) == ["checkpoint-1",
                                            "checkpoint-2.tmp"]
    latest = tckpt.latest_checkpoint(str(tmp_path))
    assert latest == str(tmp_path / "checkpoint-1")
    for _, t in ts:
        t.zero_()
    assert tckpt.restore_checkpoint(latest, ts, opt) == 1
    for (_, t), want in zip(ts, saved):
        assert torch.equal(t, want)
    # the next save of that step replaces the uncommitted corpse
    tckpt.save_checkpoint(str(tmp_path), tckpt.train_state(ts, opt, 2), 2,
                          total_limit=1)
    assert sorted(os.listdir(tmp_path)) == ["checkpoint-2"]


@pytest.mark.parametrize("change", ["path", "shape", "dtype", "optimizer"])
def test_restore_into_a_different_trainer_raises(tmp_path, change):
    ts, opt = _trainer()
    opt.step([torch.ones_like(t) for _, t in ts])
    path = tckpt.save_checkpoint(str(tmp_path),
                                 tckpt.train_state(ts, opt, 1), 1)
    other = {"path": dict(shapes=((4, 6), (3,))),
             "shape": dict(shapes=((4, 7), (3,))),
             "dtype": dict(dtype=torch.bfloat16),
             "optimizer": dict(kind="adamw8bit")}[change]
    ts2, opt2 = _trainer(**other)
    if change == "path":
        ts2 = [(("blk", 5, "w"), ts2[0][1]), ts2[1]]
    before = [t.clone() for _, t in ts2]
    with pytest.raises(ValueError):
        tckpt.restore_checkpoint(path, ts2, opt2)
    # nothing was loaded
    assert opt2.count == 0
    for (_, t), b in zip(ts2, before):
        assert torch.equal(t, b)


# ------------------------------------------------------------ metrics log

def _lines(path):
    import json
    with open(path) as f:
        return [json.loads(ln) for ln in f.read().splitlines()]


def test_metrics_log_matches_jax(tmp_path):
    scalars = [{"loss": 0.5, "sec_per_step": 1.25}, {"loss": np.float32(2)}]
    for mod, d in ((tobs, tmp_path / "port"), (jobs, tmp_path / "jax")):
        for _ in range(2):  # a second logger appends, as a resumed run
            log = mod.MetricsLogger(str(d))
            for step, sc in enumerate(scalars):
                log.log(step, sc)
            log.close()
    got, want = _lines(tmp_path / "port" / "metrics.jsonl"), \
        _lines(tmp_path / "jax" / "metrics.jsonl")
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert set(g) == set(w) and g["step"] == w["step"]
        assert all(g[k] == w[k] for k in g if k != "time")
    off = tobs.MetricsLogger(str(tmp_path / "off"), enabled=False)
    off.log(0, {"loss": 1.0})
    off.close()
    assert off.path is None and not (tmp_path / "off").exists()


# ------------------------------------------------------------ resume

@pytest.fixture(scope="module")
def mp4_dir(tmp_path_factory):
    """One 5-frame and one 4-frame mp4: 2 + 1 clip starts of 4 frames."""
    root = tmp_path_factory.mktemp("clips")
    rng = np.random.default_rng(1)
    for name, n in [("a.mp4", 5), ("b.mp4", 4)]:
        w = cv2.VideoWriter(str(root / name), cv2.VideoWriter_fourcc(*"mp4v"),
                            8, (32, 32))
        for i in range(n):
            w.write(rng.integers(0, 200, (32, 32, 3), dtype=np.uint8))
        w.release()
    return str(root)


def _args(mp4_dir, out, *extra, epochs=True):
    return train_animatediff.build_parser().parse_args([
        "--smoke", "--device", "cpu", "--prompt", "a horse",
        "--video_dir", mp4_dir, "--checkpointing_steps", "1",
        "--lr_warmup_steps", "1", "--learning_rate", "1e-3",
        "--log_every", "2", "--output_dir", out,
        *(["--num_train_epochs", "1"] if epochs else []), *extra])


def _jax_epoch_steps(epochs, n_items, batch, accum):
    """JAX cli/train_animatediff.py's accounting (one process)."""
    batches = max(-(-n_items // batch), 1)
    return epochs * max(-(-batches // accum), 1)


@pytest.mark.parametrize("epochs,n_items,batch,accum", [
    (1, 5, 1, 1), (2, 5, 2, 1), (1, 5, 2, 2), (3, 1, 4, 3), (1, 12, 5, 2)])
def test_epoch_step_count_follows_jax(epochs, n_items, batch, accum):
    args = train_animatediff.build_parser().parse_args([
        "--num_train_epochs", str(epochs), "--train_batch_size", str(batch),
        "--gradient_accumulation_steps", str(accum)])
    assert train_animatediff.train_steps(args, n_items) == \
        _jax_epoch_steps(epochs, n_items, batch, accum)
    args.num_train_epochs = None
    assert train_animatediff.train_steps(args, n_items) == 1000


def test_parses_the_reference_launch():
    """Every flag of the reference's stage-2 launch
    (examples/train_animatediff.sh), with the port's module, parses."""
    import pathlib
    import shlex
    text = (pathlib.Path(__file__).resolve().parent.parent / "examples"
            / "train_animatediff.sh").read_text()
    launch = text[text.index("python -m"):].replace("\\\n", " ")
    words = shlex.split(launch.splitlines()[0])
    assert words[2] == "video_style_transfer_tpu.cli.train_animatediff"
    argv = [w.replace("$", "") for w in words[3:]]
    flags = [w for w in argv if w.startswith("--")]
    assert "--video_dir" in flags and len(flags) == 17
    args = train_animatediff.build_parser().parse_args(argv)
    assert args.video_dir == "VIDEO_DIR" and args.max_train_steps == 1000
    assert args.checkpoint_format == "pth"


@pytest.fixture(scope="module")
def resumed(mp4_dir, tmp_path_factory):
    """The smoke trainer over one epoch of the mp4s (a checkpoint a step),
    and a fresh trainer restored from its last checkpoint."""
    out = str(tmp_path_factory.mktemp("run"))
    report = {}
    ran = train_animatediff.train(_args(mp4_dir, out), report)
    fresh = train_animatediff.prepare(
        _args(mp4_dir, out, "--resume_from_checkpoint", "latest"))
    return ran, fresh, report, out


def test_resume_run_writes_a_checkpoint_a_step(resumed):
    ran, fresh, report, out = resumed
    assert ran.max_steps == len(ran.dataset) == 3
    assert len(report["loss"]) == 3 and np.isfinite(report["loss"]).all()
    names = sorted(os.listdir(os.path.join(out, "checkpoints")))
    assert names == [f"checkpoint-{s}" for s in range(1, 4)]
    assert report["checkpoints"] == [os.path.join(out, "checkpoints", n)
                                     for n in names]
    # the cache: 4-frame clips of 5- and 4-frame videos hold 9 frames
    assert sum(report["encoded_frames"]) == ran.cache.misses <= 9
    assert fresh.start == 3 and fresh.resumed_from.endswith("checkpoint-3")
    with open(os.path.join(out, "metrics.jsonl")) as f:
        lines = f.read().splitlines()
    assert len(lines) == 2  # step 0 and the last


def test_resumed_trainer_takes_the_same_next_step(resumed):
    ran, fresh, _, _ = resumed
    assert [p for p, _ in ran.trainable] == [p for p, _ in fresh.trainable]
    for (_, a), (_, b) in zip(ran.trainable, fresh.trainable):
        assert a.dtype == b.dtype and torch.equal(a, b)
    _assert_tree_equal(fresh.optimizer.state_dict(),
                       ran.optimizer.state_dict())
    # the next learning rate is the uninterrupted run's
    assert fresh.optimizer.schedule(fresh.optimizer.count) == \
        ran.optimizer.schedule(ran.optimizer.count)
    for tr in (ran, fresh):
        tr.generator.manual_seed(31)
        tr.step(tr.params, train_animatediff.sample_micro_batches(tr, 3),
                tr.generator)
    for (_, a), (_, b) in zip(ran.trainable, fresh.trainable):
        assert torch.equal(a, b)
    _assert_tree_equal(fresh.optimizer.state_dict(),
                       ran.optimizer.state_dict())
    assert fresh.optimizer.count == 4


def test_resume_from_a_path_folds_its_start_step_into_the_seed(resumed):
    ran, _, _, out = resumed
    # a run from step 0 keeps its seed; each start step folds in another
    assert train_animatediff.run_seed(3, 0) == 3
    assert len({train_animatediff.run_seed(3, s) for s in range(4)}) == 4
    path = os.path.join(out, "checkpoints", "checkpoint-2")
    tr = train_animatediff.prepare(_args(
        ran.dataset.videos[0].rsplit(os.sep, 1)[0], out,
        "--resume_from_checkpoint", path))
    assert (tr.start, tr.resumed_from) == (2, path)
    assert tr.generator.initial_seed() == train_animatediff.run_seed(0, 2)
    assert tr.optimizer.count == 2
