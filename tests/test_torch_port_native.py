"""The port's native clip preprocessing (data/native.py, its own copy of
native/preprocess.cpp built with the Makefile's flags) held against the
JAX package's data/native.py: the native functions bitwise (same source,
same flags), the plain versions bitwise against JAX's numpy fallbacks,
and native against plain within one level of the resize (0.01 after the
normalisation), as the JAX package's tests/test_native.py holds them. A
build that fails prints the compiler's log and leaves the plain path."""
import numpy as np
import pytest

from video_style_transfer_tpu.data import native as jnative
from video_style_transfer_tpu_torch.data import native as tnative

SHAPES = [((24, 40, 3), 16, 16), ((37, 53, 3), 64, 48), ((8, 8, 1), 5, 13)]


@pytest.fixture(scope="module")
def both_native():
    if not jnative.native_available():
        pytest.skip("the JAX package's native preprocessing did not build")
    assert tnative.native_available()


def _img(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape,
                                                dtype=np.uint8)


@pytest.mark.parametrize("shape,dh,dw", SHAPES)
def test_native_resize_equals_jax_native(both_native, shape, dh, dw):
    img = _img(1, shape)
    got = tnative.resize_bilinear(img, dh, dw)
    assert got.shape == (dh, dw, shape[2]) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, jnative.resize_bilinear(img, dh, dw))
    plain = tnative.resize_bilinear_plain(img, dh, dw)
    assert np.abs(got.astype(int) - plain.astype(int)).max() <= 1


def test_native_clip_preprocessing_equals_jax_native(both_native):
    frames = _img(2, (3, 30, 50, 3))
    got = tnative.preprocess_frames_bgr(frames, 16, 24)
    assert got.shape == (3, 16, 24, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(
        got, jnative.preprocess_frames_bgr(frames, 16, 24))
    plain = tnative.preprocess_frames_bgr_plain(frames, 16, 24)
    assert np.abs(got - plain).max() <= 0.01
    units = tnative.u8_to_unit_range(frames)
    np.testing.assert_array_equal(units, jnative.u8_to_unit_range(frames))
    # a product by 1/127.5 against numpy's quotient: an ulp apart
    np.testing.assert_allclose(units, tnative.u8_to_unit_range_plain(frames),
                               rtol=0, atol=2e-7)


def test_plain_versions_equal_jax_fallbacks(monkeypatch):
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_lib_tried", True)
    frames = _img(3, (2, 21, 34, 3))
    for shape, dh, dw in SHAPES:
        img = _img(4, shape)
        np.testing.assert_array_equal(
            tnative.resize_bilinear_plain(img, dh, dw),
            jnative.resize_bilinear(img, dh, dw))
    np.testing.assert_array_equal(
        tnative.preprocess_frames_bgr_plain(frames, 16, 16),
        jnative.preprocess_frames_bgr(frames, 16, 16))
    np.testing.assert_array_equal(tnative.u8_to_unit_range_plain(frames),
                                  jnative.u8_to_unit_range(frames))


def test_failed_build_prints_the_log_and_takes_the_plain_path(
        tmp_path, monkeypatch, capsys):
    if tnative._cxx() is None:
        pytest.skip("no g++")
    bad = tmp_path / "preprocess.cpp"
    bad.write_text("extern \"C\" { void u8_to_unit_range( }\n")
    monkeypatch.setattr(tnative, "SOURCE", bad)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_lib_tried", False)
    assert not tnative.native_available()
    err = capsys.readouterr().err
    # both builds (with OpenMP, then without) fail and print their logs
    assert err.count("native preprocessing:") == 4
    assert err.count("failed (exit") == 2 and "without OpenMP" in err
    assert "preprocess.cpp" in err  # the compiler's own diagnostics
    # printed once: the next call finds the decision made
    assert not tnative.native_available()
    assert capsys.readouterr().err == ""
    frames = _img(5, (1, 9, 9, 3))
    np.testing.assert_array_equal(
        tnative.preprocess_frames_bgr(frames, 4, 4),
        tnative.preprocess_frames_bgr_plain(frames, 4, 4))
    assert not list((tmp_path / "_build").glob("*.so"))


def test_build_without_openmp_gives_the_same_results(tmp_path, monkeypatch,
                                                     capsys):
    """Where -fopenmp fails (a toolchain without libgomp), the one-thread
    build takes over, with the same results."""
    if not tnative.native_available():
        pytest.skip("no native library here")
    cxx = tnative._cxx()
    want = tnative.preprocess_frames_bgr(_img(6, (2, 30, 50, 3)), 16, 24)
    monkeypatch.setattr(tnative, "CXX_FLAGS",
                        tnative.CXX_FLAGS + ["-no-such-flag"])
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_lib_tried", False)
    assert tnative.native_available()
    assert tnative.build_info["openmp"] is False
    assert "without OpenMP" in capsys.readouterr().err
    assert tnative.build_info["path"] == str(
        tnative.library_path(cxx, tnative.SERIAL_FLAGS))
    np.testing.assert_array_equal(
        tnative.preprocess_frames_bgr(_img(6, (2, 30, 50, 3)), 16, 24), want)


def test_library_is_keyed_by_the_source(tmp_path, monkeypatch):
    cxx = tnative._cxx() or "g++"
    src = tmp_path / "a.cpp"
    src.write_text("int x;\n")
    monkeypatch.setattr(tnative, "SOURCE", src)
    first = tnative.library_path(cxx)
    src.write_text("int y;\n")
    assert tnative.library_path(cxx) != first
    assert first.parent == tnative.BUILD_DIR
    assert first.name.startswith("libvst_preprocess_")
