"""Video clips for stage 2, frame extraction and image directories for
stage 1 (the JAX package's data/video.py, its cv2 decode path).

- VideoClipDataset: the .mp4s under a directory (and one level of
  subdirectories), one index entry per clip start; a clip is that many
  CONSECUTIVE frames, BGR -> RGB, resized square (INTER_LINEAR),
  normalised to [-1, 1], a short read padded by repeating its last frame.
- extract_frames: N evenly spaced frames of one video (its middle frame
  when N == 1), resized with INTER_AREA; extract_first_frames: its first
  N consecutive frames;
- load_image_dir: stage 1's instance or class images from a directory
  (PIL, squished, centre- or randomly cropped to square).

Clips are drawn by an integer seed through ``np.random.RandomState``, as
the JAX package draws them, so both pick the same clips. Frames come out
(F, H, W, 3) float32, channels last, the layout the models take. cv2 is
imported inside the functions that decode: nothing needs it at import.
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np


def _require_cv2():
    try:
        import cv2
        return cv2
    except ImportError as e:
        raise ImportError("opencv-python is required to decode video") from e


def list_videos(root: str) -> List[str]:
    """The .mp4 files directly under root and one level of
    subdirectories down, sorted."""
    out = []
    for entry in sorted(os.listdir(root)):
        p = os.path.join(root, entry)
        if entry.lower().endswith(".mp4"):
            out.append(p)
        elif os.path.isdir(p):
            for sub in sorted(os.listdir(p)):
                if sub.lower().endswith(".mp4"):
                    out.append(os.path.join(p, sub))
    return out


def _read_frames(cap, start: int, count: int, resolution: int):
    """Up to `count` consecutive frames from `start`, RGB, resized to
    resolution² with INTER_LINEAR; fewer where the video ends."""
    cv2 = _require_cv2()
    cap.set(cv2.CAP_PROP_POS_FRAMES, start)
    frames = []
    for _ in range(count):
        ok, frame = cap.read()
        if not ok:
            break
        frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
        frames.append(cv2.resize(frame, (resolution, resolution),
                                 interpolation=cv2.INTER_LINEAR))
    return frames


def _pad_repeat(frames: List[np.ndarray], count: int) -> List[np.ndarray]:
    while frames and len(frames) < count:
        frames.append(frames[-1].copy())
    return frames


def _normalize(frames: Sequence[np.ndarray]) -> np.ndarray:
    """uint8 frames -> (N, H, W, 3) float32 in [-1, 1]."""
    return np.stack(frames).astype(np.float32) / 127.5 - 1.0


class VideoClipDataset:
    """Index of (video, start frame) pairs with random-access clip
    loading: ``ds[i]`` is a (F, H, W, 3) float32 clip in [-1, 1]."""

    def __init__(self, root: str, *, num_frames: int = 8,
                 resolution: int = 1024, stride: int = 1):
        cv2 = _require_cv2()
        self.num_frames = num_frames
        self.resolution = resolution
        self.videos = list_videos(root)
        if not self.videos:
            raise FileNotFoundError(f"no .mp4 under {root}")
        self.index: List[Tuple[str, int]] = []
        for path in self.videos:
            cap = cv2.VideoCapture(path)
            total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
            cap.release()
            for s in range(0, max(total - num_frames + 1, 1), stride):
                self.index.append((path, s))

    def __len__(self) -> int:
        return len(self.index)

    def _load(self, i: int):
        """(frames (F, H, W, 3) float32 in [-1, 1], n_read): n_read counts
        the frames actually decoded (the padded tail repeats frame
        n_read - 1), so frame ids built from it hold even where the
        container's frame count is wrong."""
        cv2 = _require_cv2()
        path, start = self.index[i]
        cap = cv2.VideoCapture(path)
        try:
            frames = _read_frames(cap, start, self.num_frames,
                                  self.resolution)
        finally:
            cap.release()
        if not frames:
            raise IOError(f"failed to read frames from {path}@{start}")
        n_read = len(frames)
        return _normalize(_pad_repeat(frames, self.num_frames)), n_read

    def __getitem__(self, i: int) -> np.ndarray:
        return self._load(i)[0]

    def sample_batch(self, batch_size: int, seed: int) -> np.ndarray:
        """(B, F, H, W, 3), a function of the seed."""
        idx = np.random.RandomState(seed).randint(0, len(self.index),
                                                  size=batch_size)
        return np.stack([self[int(i)] for i in idx])

    def _ids_for(self, i: int, n_read: int) -> List[Tuple[int, int]]:
        path, start = self.index[i]
        vid = self.videos.index(path)
        last = start + n_read - 1
        return [(vid, min(start + j, last)) for j in range(self.num_frames)]

    def frame_ids(self, i: int) -> List[Tuple[int, int]]:
        """(video_idx, frame_idx) of each frame of clip i; the padded tail
        takes the id of the last frame actually read, so a cache of
        per-frame latent moments keyed on these ids is exact. Decodes the
        clip to count its reads (sample_batch_meta gives frames and ids
        from one decode)."""
        return self._ids_for(i, self._load(i)[1])

    def sample_batch_meta(self, batch_size: int, seed: int):
        """sample_batch's clips with their frame ids: (frames (B, F, H,
        W, 3), ids[b][j] = (video_idx, frame_idx))."""
        idx = np.random.RandomState(seed).randint(0, len(self.index),
                                                  size=batch_size)
        loads = [self._load(int(i)) for i in idx]
        frames = np.stack([f for f, _ in loads])
        ids = [self._ids_for(int(i), n) for i, (_, n) in zip(idx, loads)]
        return frames, ids


def extract_frames(video_path: str, num_frames: int = 1,
                   resolution: Optional[int] = None) -> np.ndarray:
    """N evenly spaced frames (the middle frame when N == 1), resized with
    INTER_AREA where `resolution` is given -> (N, H, W, 3) float32 in
    [-1, 1], a short read padded by repeating its last frame."""
    cv2 = _require_cv2()
    cap = cv2.VideoCapture(video_path)
    try:
        total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        if total <= 0:
            raise IOError(f"unreadable video: {video_path}")
        if num_frames == 1:
            positions = [total // 2]
        else:
            positions = np.linspace(0, total - 1,
                                    num_frames).round().astype(int)
        frames = []
        for pos in positions:
            cap.set(cv2.CAP_PROP_POS_FRAMES, int(pos))
            ok, frame = cap.read()
            if not ok:
                continue
            frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            if resolution is not None:
                frame = cv2.resize(frame, (resolution, resolution),
                                   interpolation=cv2.INTER_AREA)
            frames.append(frame)
    finally:
        cap.release()
    if not frames:
        raise IOError(f"no frames decoded from {video_path}")
    return _normalize(_pad_repeat(frames, num_frames))


def extract_first_frames(video_path: str, num_frames: int,
                         resolution: int) -> np.ndarray:
    """The first N consecutive frames -> (N, H, W, 3) float32 in [-1, 1],
    a short read padded by repeating its last frame."""
    cv2 = _require_cv2()
    cap = cv2.VideoCapture(video_path)
    try:
        frames = _read_frames(cap, 0, num_frames, resolution)
    finally:
        cap.release()
    if not frames:
        raise IOError(f"no frames decoded from {video_path}")
    return _normalize(_pad_repeat(frames, num_frames))


IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".webp", ".bmp")


def load_image_dir(root: str, resolution: int, *, crop: str = "squish",
                   seed: int = 0) -> np.ndarray:
    """Every image under root, in name order -> (N, res, res, 3) float32
    in [-1, 1] (stage 1's instance or class images). crop: "squish"
    resizes both axes (LANCZOS); "center" and "random" resize the shorter
    side to res and crop the other, the random offsets drawn once per
    image from `seed`. PIL is imported here: nothing else needs it."""
    from PIL import Image
    paths = [os.path.join(root, f) for f in sorted(os.listdir(root))
             if f.lower().endswith(IMAGE_EXTS)]
    if not paths:
        raise FileNotFoundError(f"no images under {root}")
    if crop not in ("squish", "center", "random"):
        raise ValueError(f"unknown crop mode {crop!r}")
    rng = np.random.default_rng(seed)
    out = []
    for p in paths:
        with Image.open(p) as src:
            img = src.convert("RGB")
        if crop == "squish":
            img = img.resize((resolution, resolution), Image.LANCZOS)
        else:
            w, h = img.size
            scale = resolution / min(w, h)
            nw = max(round(w * scale), resolution)
            nh = max(round(h * scale), resolution)
            img = img.resize((nw, nh), Image.LANCZOS)
            if crop == "center":
                left, top = (nw - resolution) // 2, (nh - resolution) // 2
            else:
                left = int(rng.integers(0, nw - resolution + 1))
                top = int(rng.integers(0, nh - resolution + 1))
            img = img.crop((left, top, left + resolution, top + resolution))
        out.append(np.asarray(img))
    return _normalize(out)
