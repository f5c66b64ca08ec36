"""Video and image output: mp4 via imageio/libx264 at quality 8, GIF when
no H.264 encoder is available (the reference's export behaviour, 8 fps);
png via PIL. Both libraries are imported inside the writers: only a
CLI's ``main()`` needs them."""
from __future__ import annotations

import os
from typing import Sequence

import numpy as np


def save_video(frames: Sequence[np.ndarray], path: str, *, fps: int = 8,
               quality: int = 8) -> str:
    """frames: (H, W, 3) uint8 each. Returns the path written (.mp4, or
    .gif on fallback)."""
    import imageio.v2 as imageio
    frames = [np.asarray(f, np.uint8) for f in frames]
    writer = None
    try:
        writer = imageio.get_writer(path, fps=fps, quality=quality,
                                    codec="libx264")
        for f in frames:
            writer.append_data(f)
        writer.close()
        return path
    except Exception:
        # no H.264 encoder: drop any truncated .mp4 and write a GIF
        if writer is not None:
            try:
                writer.close()
            except Exception:
                pass
        if os.path.exists(path):
            os.remove(path)
        gif_path = os.path.splitext(path)[0] + ".gif"
        imageio.mimsave(gif_path, frames, duration=1.0 / fps)
        return gif_path


def save_image(img: np.ndarray, path: str) -> str:
    from PIL import Image
    Image.fromarray(np.asarray(img, np.uint8)).save(path)
    return path
