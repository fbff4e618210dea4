"""Video IO via ffmpeg rawvideo pipes, copied from
codeformer_tpu/utils/video_util.py (reference: basicsr/utils/video_util.py
— VideoReader frame pipe + meta probe, VideoWriter x264 with audio mux).
Gated on ffmpeg availability, with a cv2 writer (no audio) where ffmpeg
is absent; frames flow as uint8 BGR numpy arrays so the restoration
pipeline can batch N frames per device step.
"""
from __future__ import annotations

import json
import shutil
import subprocess
from typing import Iterator, List, Optional

import numpy as np


def have_ffmpeg() -> bool:
    return shutil.which('ffmpeg') is not None and \
        shutil.which('ffprobe') is not None


def _probe(path: str) -> dict:
    out = subprocess.check_output(
        ['ffprobe', '-v', 'error', '-show_streams', '-show_format',
         '-of', 'json', path])
    return json.loads(out)


class VideoReader:
    """Decode a video to uint8 BGR frames through an ffmpeg pipe."""

    def __init__(self, video_path: str):
        if not have_ffmpeg():
            raise RuntimeError('ffmpeg/ffprobe not found on PATH — video '
                               'IO is unavailable in this environment')
        self.video_path = video_path
        meta = _probe(video_path)
        vstream = next(s for s in meta['streams']
                       if s['codec_type'] == 'video')
        self.width = int(vstream['width'])
        self.height = int(vstream['height'])
        num, den = vstream.get('avg_frame_rate', '25/1').split('/')
        self.fps = float(num) / float(den) if float(den) else 25.0
        self.nb_frames = int(vstream.get('nb_frames', 0) or 0)
        self.has_audio = any(s['codec_type'] == 'audio'
                             for s in meta['streams'])
        self._proc = subprocess.Popen(
            ['ffmpeg', '-v', 'error', '-i', video_path, '-f', 'rawvideo',
             '-pix_fmt', 'bgr24', '-'],
            stdout=subprocess.PIPE, bufsize=10 ** 8)

    def get_fps(self) -> float:
        return self.fps

    def get_audio(self) -> Optional[str]:
        """Returns the source path if it has an audio stream (the writer
        muxes audio straight from the source)."""
        return self.video_path if self.has_audio else None

    def get_frame(self) -> Optional[np.ndarray]:
        raw = self._proc.stdout.read(self.width * self.height * 3)
        if len(raw) < self.width * self.height * 3:
            return None
        return np.frombuffer(raw, np.uint8).reshape(
            self.height, self.width, 3).copy()

    def frames(self, batch: int = 1) -> Iterator[List[np.ndarray]]:
        """Yield frames in batches of `batch` (the batched access
        pattern; the reference reads one frame at a time)."""
        buf: List[np.ndarray] = []
        while True:
            f = self.get_frame()
            if f is None:
                break
            buf.append(f)
            if len(buf) == batch:
                yield buf
                buf = []
        if buf:
            yield buf

    def close(self):
        if self._proc.stdout:
            self._proc.stdout.close()
        self._proc.terminate()
        self._proc.wait()


class Cv2VideoWriter:
    """cv2 fallback writer for ffmpeg-less environments.

    LIMITATION: cv2.VideoWriter cannot mux audio. When an audio source is
    given it is dropped with a loud warning — install ffmpeg to preserve
    it (the reference's VideoWriter behavior, video_util.py:89-125)."""

    def __init__(self, video_save_path: str, height: int, width: int,
                 fps: float, audio=None):
        import cv2
        import os
        if audio is not None:
            import warnings
            warnings.warn(
                f'writing {video_save_path} WITHOUT audio: the cv2 '
                f'fallback writer cannot mux the source audio stream '
                f'({audio}); install ffmpeg to preserve it')
        os.makedirs(os.path.dirname(os.path.abspath(video_save_path)),
                    exist_ok=True)
        fourcc = cv2.VideoWriter_fourcc(*'mp4v')
        self._w = cv2.VideoWriter(video_save_path, fourcc, fps,
                                  (width, height))
        if not self._w.isOpened():
            raise RuntimeError(f'cv2.VideoWriter failed for '
                               f'{video_save_path}')

    def write_frame(self, frame: np.ndarray):
        self._w.write(frame.astype(np.uint8))

    def close(self):
        self._w.release()


def make_video_writer(video_save_path: str, height: int, width: int,
                      fps: float, audio=None):
    """ffmpeg writer when available (audio muxing), else cv2 fallback."""
    if have_ffmpeg():
        return VideoWriter(video_save_path, height, width, fps, audio)
    return Cv2VideoWriter(video_save_path, height, width, fps, audio)


class VideoWriter:
    """Encode uint8 BGR frames to x264 mp4, muxing audio from a source."""

    def __init__(self, video_save_path: str, height: int, width: int,
                 fps: float, audio: Optional[str] = None):
        if not have_ffmpeg():
            raise RuntimeError('ffmpeg not found on PATH')
        cmd = ['ffmpeg', '-v', 'error', '-y',
               '-f', 'rawvideo', '-pix_fmt', 'bgr24',
               '-s', f'{width}x{height}', '-r', str(fps), '-i', '-']
        if audio is not None:
            cmd += ['-i', audio, '-map', '0:v', '-map', '1:a?',
                    '-c:a', 'copy', '-shortest']
        cmd += ['-c:v', 'libx264', '-pix_fmt', 'yuv420p',
                '-crf', '18', video_save_path]
        self._proc = subprocess.Popen(cmd, stdin=subprocess.PIPE)

    def write_frame(self, frame: np.ndarray):
        self._proc.stdin.write(frame.astype(np.uint8).tobytes())

    def close(self):
        self._proc.stdin.close()
        self._proc.wait()
