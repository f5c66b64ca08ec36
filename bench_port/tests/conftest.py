"""The tiny registry fixture (``tiny.py``)."""
from __future__ import annotations

import pytest

from bench_port.tests.tiny import make_root, tiny_traffic


@pytest.fixture
def tiny_registry(tmp_path):
    from bench_port.registry import Registry
    root = make_root(tmp_path, {
        "tiny_video": (tiny_traffic("video"), "video"),
        "tiny_image": (tiny_traffic("image"), "image")})
    return Registry(root, root / "bench_port")
