"""Video recording of rollouts (port of the JAX package's ``video.py``; the reference's
``arp_dt/video_recorder.py``).  ``imageio`` is imported when a video is written, so the
package needs it only to write one."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def save_video(frames: np.ndarray, path: str, fps: int = 20) -> str:
    """Write (T, H, W, C) uint8 frames to mp4 (imageio / ffmpeg); returns the path written."""
    import imageio

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    frames = np.asarray(frames)
    if frames.dtype != np.uint8:
        frames = np.clip(frames, 0, 255).astype(np.uint8)
    try:
        with imageio.get_writer(path, fps=fps) as writer:
            for frame in frames:
                writer.append_data(frame)
        return path
    except (ValueError, ImportError):
        # no ffmpeg backend: fall back to GIF (always encodable via PIL)
        gif_path = os.path.splitext(path)[0] + ".gif"
        imageio.mimsave(gif_path, list(frames), duration=1.0 / fps)
        return gif_path


class VideoRecorder:
    def __init__(self, save_dir: str, fps: int = 20):
        self.save_dir = save_dir
        self.fps = fps
        self.frames: list = []
        os.makedirs(save_dir, exist_ok=True)

    def record(self, frame: np.ndarray):
        self.frames.append(np.asarray(frame))

    def save(self, name: str) -> Optional[str]:
        """Write the buffered frames; no-op (returns None) when nothing was recorded."""
        if not self.frames:
            return None
        path = os.path.join(self.save_dir, name if name.endswith(".mp4") else name + ".mp4")
        path = save_video(np.stack(self.frames), path, fps=self.fps)
        self.frames.clear()
        return path
