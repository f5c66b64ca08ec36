"""The port's video clip dataset (data/video.py) and latent-moment cache
(cli/common.py LatentMomentCache) held against the JAX package's, on two
tiny mp4s written here and the tiny VAE with weights carried across from
JAX. Both packages take the native fused preprocessing where its library
builds, else the cv2 chain; the clips must be equal on either path: most
cases switch the native library off in both packages, one holds the two
native paths against each other."""
import os
from types import SimpleNamespace

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from video_style_transfer_tpu.cli import common as jcommon
from video_style_transfer_tpu.config import VAEConfig as JVAEConfig
from video_style_transfer_tpu.data import native as jnative
from video_style_transfer_tpu.data import video as jvideo
from video_style_transfer_tpu.models import vae as jvae
from video_style_transfer_tpu_torch.cli import common as tcommon
from video_style_transfer_tpu_torch.config import VAEConfig
from video_style_transfer_tpu_torch.data import native as tnative
from video_style_transfer_tpu_torch.data import video as tvideo
from video_style_transfer_tpu_torch.utils import convert

cv2 = pytest.importorskip("cv2")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The tiny VAE's ops are too small to share among threads; one
    thread a test process keeps them quick while the suite's workers
    share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



@pytest.fixture(scope="module")
def video_dir(tmp_path_factory):
    """Two tiny textured mp4s, 12 and 6 frames of 24 x 40, one of them in
    a subdirectory; each frame seeded noise plus its index."""
    root = tmp_path_factory.mktemp("videos")
    os.makedirs(root / "sub")
    rng = np.random.default_rng(0)
    for name, n_frames in [("a.mp4", 12), ("sub/b.mp4", 6)]:
        w = cv2.VideoWriter(str(root / name), cv2.VideoWriter_fourcc(*"mp4v"),
                            8, (40, 24))
        for i in range(n_frames):
            noise = rng.integers(0, 160, (24, 40, 3), dtype=np.uint8)
            w.write(noise + np.uint8(i * 8))
        w.release()
    return str(root)


@pytest.fixture
def jax_cv2_only(monkeypatch):
    """Both datasets on their cv2 decode path (the native library
    switched off in both packages)."""
    for mod in (jnative, tnative):
        monkeypatch.setattr(mod, "_lib", None)
        monkeypatch.setattr(mod, "_lib_tried", True)
        assert not mod.native_available()


def test_list_videos_matches_jax(video_dir):
    got = tvideo.list_videos(video_dir)
    assert got == jvideo.list_videos(video_dir)
    assert [os.path.basename(p) for p in got] == ["a.mp4", "b.mp4"]


@pytest.mark.parametrize("num_frames", [4, 8])
def test_index_matches_jax(video_dir, num_frames):
    t = tvideo.VideoClipDataset(video_dir, num_frames=num_frames,
                                resolution=16)
    j = jvideo.VideoClipDataset(video_dir, num_frames=num_frames,
                                resolution=16)
    assert t.videos == j.videos
    assert t.index == j.index
    # a: 12 - F + 1 starts; b: 6 - F + 1, at least one
    assert len(t) == (12 - num_frames + 1) + max(6 - num_frames + 1, 1)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_sample_batch_meta_matches_jax(video_dir, jax_cv2_only, seed):
    t = tvideo.VideoClipDataset(video_dir, num_frames=8, resolution=16)
    j = jvideo.VideoClipDataset(video_dir, num_frames=8, resolution=16)
    tf, tids = t.sample_batch_meta(3, seed)
    jf, jids = j.sample_batch_meta(3, seed)
    assert tf.dtype == np.float32 and tf.shape == (3, 8, 16, 16, 3)
    np.testing.assert_array_equal(tf, jf)
    assert tids == jids
    np.testing.assert_array_equal(t.sample_batch(3, seed), tf)


def test_frame_ids_pad_tail_matches_jax(video_dir, jax_cv2_only):
    t = tvideo.VideoClipDataset(video_dir, num_frames=8, resolution=16)
    j = jvideo.VideoClipDataset(video_dir, num_frames=8, resolution=16)
    short = [i for i, (p, _) in enumerate(t.index) if p.endswith("b.mp4")]
    assert len(short) == 1
    ids = t.frame_ids(short[0])
    assert ids == j.frame_ids(short[0])
    # 6 frames read, the two padded ones take the id of frame 5
    assert ids == [(1, k) for k in range(6)] + [(1, 5), (1, 5)]
    clip = t[short[0]]
    np.testing.assert_array_equal(clip[6], clip[5])
    np.testing.assert_array_equal(clip[7], clip[5])
    np.testing.assert_array_equal(clip, j[short[0]])


def test_clips_within_a_level_of_jax_native_path(video_dir):
    """Both packages on their native path: the clips are equal (zero
    levels apart; the port's copy of the source, built with the same
    flags)."""
    if not jnative.native_available():
        pytest.skip("the JAX package's native preprocessing did not build")
    t = tvideo.VideoClipDataset(video_dir, num_frames=4, resolution=16)
    j = jvideo.VideoClipDataset(video_dir, num_frames=4, resolution=16)
    assert t.preprocess == "native"
    tf, tids = t.sample_batch_meta(4, 5)
    jf, jids = j.sample_batch_meta(4, 5)
    assert tids == jids
    np.testing.assert_array_equal(tf, jf)


@pytest.mark.parametrize("num_frames,resolution", [(1, 16), (5, 16),
                                                   (3, None)])
def test_extract_frames_matches_jax(video_dir, num_frames, resolution):
    path = os.path.join(video_dir, "a.mp4")
    got = tvideo.extract_frames(path, num_frames, resolution=resolution)
    want = jvideo.extract_frames(path, num_frames, resolution=resolution)
    assert got.shape == (num_frames,) + ((resolution, resolution)
                                         if resolution else (24, 40)) + (3,)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("num_frames", [4, 8])
def test_extract_first_frames_matches_jax(video_dir, num_frames):
    path = os.path.join(video_dir, "sub", "b.mp4")
    got = tvideo.extract_first_frames(path, num_frames, 16)
    np.testing.assert_array_equal(
        got, jvideo.extract_first_frames(path, num_frames, 16))
    if num_frames > 6:  # padded by its last frame
        np.testing.assert_array_equal(got[-1], got[5])


def test_missing_video_dir_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        tvideo.VideoClipDataset(str(tmp_path / "none"), num_frames=4,
                                resolution=16)
    with pytest.raises(FileNotFoundError, match="no .mp4"):
        tvideo.VideoClipDataset(str(tmp_path), num_frames=4, resolution=16)


# ------------------------------------------------------ latent moments


@pytest.fixture(scope="module")
def vaes():
    jcfg = JVAEConfig.tiny()
    jp = jax.jit(lambda k: jvae.init_vae(k, jcfg))(jax.random.PRNGKey(2))
    tcfg = VAEConfig.tiny()
    port = SimpleNamespace(
        vae_encoder=convert.convert_vae_encoder(jp), vae_cfg=tcfg,
        device=torch.device("cpu"),
        vae_scale_factor=2 ** (len(tcfg.block_out_channels) - 1))
    return SimpleNamespace(vae=jp, vae_cfg=jcfg), port


@pytest.fixture(scope="module")
def clips(video_dir):
    """Two 8-frame clips of one batch and their ids: the short video's
    (its padded tail repeats an id) and one of the long video's."""
    ds = tvideo.VideoClipDataset(video_dir, num_frames=8, resolution=16)
    short = [i for i, (p, _) in enumerate(ds.index) if p.endswith("b.mp4")]
    idx = [short[0], 2]
    frames = np.stack([ds[i] for i in idx])
    return frames, [ds.frame_ids(i) for i in idx]


def _flat(ids):
    return [fid for clip in ids for fid in clip]


def _eps(seed, n, shape):
    g = torch.Generator().manual_seed(seed)
    return torch.cat([torch.randn((1,) + shape, generator=g)
                      for _ in range(n)])


def test_cache_moments_and_latents_match_jax(vaes, clips):
    jbundle, tbundle = vaes
    frames, ids = clips
    flat = frames.reshape(-1, 16, 16, 3)
    jcache = jcommon.LatentMomentCache(jbundle)
    tcache = tcommon.LatentMomentCache(tbundle)
    jmean, jlogvar = jcache._moments(flat, _flat(ids))
    tmean, tlogvar = tcache.moments(flat, _flat(ids))
    np.testing.assert_allclose(tmean.numpy(), jmean, atol=1e-4, rtol=0)
    np.testing.assert_allclose(tlogvar.numpy(), jlogvar, atol=1e-4, rtol=0)
    # 16 ids, 14 distinct: the short clip's two padded frames
    assert len(tcache) == len(jcache._cache) == 14
    assert (tcache.misses, tcache.hits) == (14, 2)
    # the latents from the same eps
    lat = tcache.latents(frames, ids, torch.Generator().manual_seed(9))
    eps = _eps(9, 16, tuple(tmean.shape[1:])).numpy()
    want = (jmean + np.exp(0.5 * jlogvar) * eps) \
        * jbundle.vae_cfg.scaling_factor
    assert lat.shape == (16, 8, 8, 4)
    np.testing.assert_allclose(lat.numpy(), want, atol=1e-4, rtol=0)


def test_cached_latents_equal_uncached_encode(vaes, clips):
    _, tbundle = vaes
    frames, ids = clips
    cache = tcommon.LatentMomentCache(tbundle)
    for _ in range(2):  # cold, then every frame from the cache
        got = cache.latents(frames, ids, torch.Generator().manual_seed(4))
        want = tcommon.encode_latents(
            tbundle, torch.from_numpy(frames.reshape(-1, 16, 16, 3)),
            torch.Generator().manual_seed(4))
        assert torch.equal(got, want)
    assert (cache.misses, cache.hits) == (14, 18)


def test_second_pass_makes_no_encoder_call(vaes, clips, monkeypatch):
    _, tbundle = vaes
    frames, ids = clips
    cache = tcommon.LatentMomentCache(tbundle)
    first = cache.latents(frames, ids, torch.Generator().manual_seed(1))

    def refuse(*a, **k):
        raise AssertionError("the encoder ran for a cached frame")
    monkeypatch.setattr(tcommon, "vae_encode_moments", refuse)
    again = cache.latents(frames, ids, torch.Generator().manual_seed(1))
    assert torch.equal(first, again)
    assert cache.misses == 14 and len(cache) == 14


def test_cache_past_max_entries_inserts_nothing(vaes, clips):
    jbundle, tbundle = vaes
    frames, ids = clips
    flat = frames.reshape(-1, 16, 16, 3)
    jcache = jcommon.LatentMomentCache(jbundle, max_entries=5)
    tcache = tcommon.LatentMomentCache(tbundle, max_entries=5)
    jmean, _ = jcache._moments(flat, _flat(ids))
    tmean, _ = tcache.moments(flat, _flat(ids))
    np.testing.assert_allclose(tmean.numpy(), jmean, atol=1e-4, rtol=0)
    assert len(tcache) == len(jcache._cache) == 5
    assert sorted(tcache._cache) == sorted(jcache._cache)
    # the 9 frames it did not keep are encoded again, and still not kept
    tcache.moments(flat, _flat(ids))
    assert len(tcache) == 5 and tcache.misses == 14 + 9
