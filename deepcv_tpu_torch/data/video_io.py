"""Video I/O: the YUV4MPEG2 (Y4M) reader and writer, the Y4M -> memmap
conversion, and batched frame processing on one device.

Counterpart of ``deepcv_tpu/data/video_io.py`` (``rgb_to_ycbcr``,
``ycbcr_to_rgb``, ``Y4MMeta``, ``iter_y4m``, ``read_y4m``, ``write_y4m``,
``y4m_to_memmap``, ``process_video``), in the standard library and numpy:

* Y4M is a one-line header and fixed-size planar frames; reading is one
  ``np.frombuffer`` a plane, and the reader is a generator, so a video
  larger than memory streams at constant memory. BT.601 studio-swing
  Y'CbCr <-> RGB; C444 and the C420 family (chroma box-filtered 2x2 on
  write, repeated on read). The writer's files are byte-equal to the JAX
  package's.
* :func:`process_video` maps a per-batch function over every frame on one
  device with one batch in flight: each batch is staged in a pinned host
  buffer, copied without blocking, and launched; the result of batch k - 1
  is read back only after batch k is launched.

* The ``.dvv`` container (:func:`write_dvv`, :func:`iter_dvv`,
  :func:`read_dvv`) holds clips coded by a fitted
  :class:`~deepcv_tpu_torch.codec.LosslessVideoCodec`, in the JAX
  package's layout (its header bytes are equal).

A mesh (several devices) is not ported.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Iterable, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from deepcv_tpu_torch.utils import resolve_device

__all__ = ["Y4MMeta", "iter_y4m", "read_y4m", "write_y4m", "rgb_to_ycbcr",
           "ycbcr_to_rgb", "y4m_to_memmap", "process_video", "write_dvv", "iter_dvv",
           "read_dvv"]


# --------------------------------------------------------------------------- #
# BT.601 studio-swing colour conversion (the Y4M default)
# --------------------------------------------------------------------------- #

_RGB2YCC = np.array([[65.738, 129.057, 25.064],
                     [-37.945, -74.494, 112.439],
                     [112.439, -94.154, -18.285]]) / 256.0
_YCC_OFFSET = np.array([16.0, 128.0, 128.0])
_YCC2RGB = np.linalg.inv(_RGB2YCC)


def rgb_to_ycbcr(rgb: np.ndarray) -> np.ndarray:
    """uint8 (..., 3) RGB -> uint8 (..., 3) BT.601 studio-swing Y'CbCr."""
    ycc = rgb.astype(np.float64) @ _RGB2YCC.T + _YCC_OFFSET
    return np.clip(np.rint(ycc), 0, 255).astype(np.uint8)


def ycbcr_to_rgb(ycc: np.ndarray) -> np.ndarray:
    """Inverse of :func:`rgb_to_ycbcr`, clipped (the round trip is within
    about 2 levels: studio swing quantizes)."""
    rgb = (ycc.astype(np.float64) - _YCC_OFFSET) @ _YCC2RGB.T
    return np.clip(np.rint(rgb), 0, 255).astype(np.uint8)


# --------------------------------------------------------------------------- #
# YUV4MPEG2
# --------------------------------------------------------------------------- #

_C420 = ("420", "420jpeg", "420mpeg2", "420paldv")


@dataclass(frozen=True)
class Y4MMeta:
    width: int
    height: int
    fps: Tuple[int, int] = (25, 1)
    chroma: str = "420jpeg"
    interlace: str = "p"
    aspect: Tuple[int, int] = (1, 1)

    @property
    def frame_bytes(self) -> int:
        """Bytes of one frame's planes. Chroma tags match exactly: 10/16-bit
        or alpha variants (C420p10, C444alpha) would be misread as 8-bit
        three-plane data."""
        y = self.width * self.height
        if self.chroma == "444":
            return 3 * y
        if self.chroma in _C420:
            # the three 4:2:0 sitings share one layout, read as centred
            return y + 2 * ((self.width // 2) * (self.height // 2))
        raise ValueError(f"unsupported Y4M chroma 'C{self.chroma}' (supported: 444, 420, "
                         "420jpeg, 420mpeg2, 420paldv — 8-bit, no alpha)")


def _parse_y4m_header(line: bytes) -> Y4MMeta:
    parts = line.decode("ascii", "replace").strip().split(" ")
    if parts[0] != "YUV4MPEG2":
        raise ValueError("not a YUV4MPEG2 stream")
    kw = {"chroma": "420jpeg"}
    for tok in parts[1:]:
        if not tok:
            continue
        tag, val = tok[0], tok[1:]
        if tag == "W":
            kw["width"] = int(val)
        elif tag == "H":
            kw["height"] = int(val)
        elif tag in ("F", "A"):
            n, d = val.split(":")
            kw["fps" if tag == "F" else "aspect"] = (int(n), int(d))
        elif tag == "I":
            kw["interlace"] = val
        elif tag == "C":
            kw["chroma"] = val
        # X (comment) tags are ignored
    if "width" not in kw or "height" not in kw:
        raise ValueError(f"Y4M header missing W/H: {line!r}")
    meta = Y4MMeta(**kw)
    if meta.interlace not in ("p", "?"):
        raise ValueError(f"interlaced Y4M (I{meta.interlace}) not supported")
    meta.frame_bytes  # validate the chroma tag now
    return meta


def _planes_to_rgb(buf: bytes, meta: Y4MMeta) -> np.ndarray:
    w, h = meta.width, meta.height
    y = np.frombuffer(buf, np.uint8, w * h).reshape(h, w)
    if meta.chroma.startswith("444"):
        cb = np.frombuffer(buf, np.uint8, w * h, w * h).reshape(h, w)
        cr = np.frombuffer(buf, np.uint8, w * h, 2 * w * h).reshape(h, w)
    else:                                   # 4:2:0 -> nearest upsample
        cw, ch = w // 2, h // 2
        cb = np.frombuffer(buf, np.uint8, cw * ch, w * h).reshape(ch, cw)
        cr = np.frombuffer(buf, np.uint8, cw * ch, w * h + cw * ch).reshape(ch, cw)
        cb = np.repeat(np.repeat(cb, 2, 0), 2, 1)[:h, :w]
        cr = np.repeat(np.repeat(cr, 2, 0), 2, 1)[:h, :w]
    return ycbcr_to_rgb(np.stack([y, cb, cr], axis=-1))


def _rgb_to_planes(frame: np.ndarray, meta: Y4MMeta) -> bytes:
    ycc = rgb_to_ycbcr(frame)
    y, cb, cr = ycc[..., 0], ycc[..., 1], ycc[..., 2]
    if meta.chroma.startswith("444"):
        return y.tobytes() + cb.tobytes() + cr.tobytes()
    h, w = y.shape                           # 4:2:0 -> 2x2 box, rounded

    def down(c):
        c = c.astype(np.uint16).reshape(h // 2, 2, w // 2, 2)
        return ((c.sum((1, 3)) + 2) // 4).astype(np.uint8)

    return y.tobytes() + down(cb).tobytes() + down(cr).tobytes()


def iter_y4m(path: Union[str, Path]) -> Tuple[Y4MMeta, Iterator[np.ndarray]]:
    """Open a .y4m file: (meta, a generator of uint8 (H, W, 3) RGB frames,
    read one at a time)."""
    f = open(path, "rb")
    try:
        meta = _parse_y4m_header(f.readline())
    except BaseException:
        f.close()
        raise

    def frames():
        with f:
            while True:
                marker = f.readline()
                if not marker:
                    return
                if not marker.startswith(b"FRAME"):
                    raise ValueError(f"bad frame marker {marker[:16]!r}")
                buf = f.read(meta.frame_bytes)
                if len(buf) != meta.frame_bytes:
                    raise ValueError("truncated Y4M frame")
                yield _planes_to_rgb(buf, meta)

    return meta, frames()


def read_y4m(path: Union[str, Path], limit: Optional[int] = None
             ) -> Tuple[np.ndarray, Y4MMeta]:
    """Read a .y4m file into a (T, H, W, 3) uint8 RGB array (the first
    ``limit`` frames)."""
    if limit is not None and limit < 1:
        raise ValueError(f"limit must be >= 1, got {limit}")
    meta, gen = iter_y4m(path)
    out = []
    for i, frame in enumerate(gen):
        if limit is not None and i >= limit:
            break
        out.append(frame)
    if not out:
        raise ValueError(f"no frames in {path}")
    return np.stack(out), meta


def write_y4m(path: Union[str, Path], frames: Iterable[np.ndarray],
              fps: Tuple[int, int] = (25, 1), chroma: str = "420jpeg") -> Y4MMeta:
    """Write uint8 RGB frames ((T, H, W, 3), or any iterable of (H, W, 3))
    as a .y4m file, one frame at a time, as C444 or C420jpeg (the sitings
    it writes)."""
    if chroma not in ("444", "420jpeg"):
        raise ValueError(f"write_y4m emits C444 or C420jpeg, got '{chroma}'")
    it = iter(frames)
    try:
        first = np.asarray(next(it), np.uint8)
    except StopIteration:
        raise ValueError("write_y4m: no frames") from None
    h, w = first.shape[:2]
    if chroma.startswith("420") and (h % 2 or w % 2):
        raise ValueError(f"4:2:0 needs even dimensions, got {h}x{w}")
    meta = Y4MMeta(width=w, height=h, fps=fps, chroma=chroma)
    header = f"YUV4MPEG2 W{w} H{h} F{fps[0]}:{fps[1]} Ip A1:1 C{chroma}\n".encode("ascii")
    with open(path, "wb") as f:
        f.write(header)
        for frame in _chain_one(first, it):
            frame = np.asarray(frame, np.uint8)
            if frame.shape[:2] != (h, w):
                raise ValueError(f"frame shape {frame.shape[:2]} != first frame's ({h}, {w})")
            f.write(b"FRAME\n")
            f.write(_rgb_to_planes(frame, meta))
    return meta


def _chain_one(first, rest):
    yield first
    yield from rest


def y4m_to_memmap(src: Union[str, Path], out_path: Union[str, Path]) -> np.memmap:
    """Stream a .y4m into a .npy memmap of uint8 (T, H, W, 3) frames,
    allocated once: the frame count comes from the file size (Y4M frames
    are fixed-size)."""
    src, out_path = Path(src), Path(out_path)
    meta, gen = iter_y4m(src)
    with open(src, "rb") as f:
        header_len = len(f.readline())
    n = (src.stat().st_size - header_len) // (len(b"FRAME\n") + meta.frame_bytes)
    if n <= 0:
        raise ValueError(f"no frames in {src}")
    mm = np.lib.format.open_memmap(out_path, mode="w+", dtype=np.uint8,
                                   shape=(n, meta.height, meta.width, 3))
    t = 0
    try:
        for frame in gen:
            mm[t] = frame
            t += 1
        if t != n:
            raise ValueError(f"frame count mismatch: sized for {n}, read {t} (per-frame "
                             "FRAME parameters are not supported)")
    except BaseException:
        del mm
        out_path.unlink(missing_ok=True)
        raise
    mm.flush()
    return mm


# --------------------------------------------------------------------------- #
# Batched frame processing
# --------------------------------------------------------------------------- #

def _chunks(frames, batch_size: int) -> Iterator[np.ndarray]:
    if isinstance(frames, np.ndarray):
        for i in range(0, len(frames), batch_size):
            yield frames[i:i + batch_size]
        return
    buf = []
    for fr in frames:
        buf.append(np.asarray(fr))
        if len(buf) == batch_size:
            yield np.stack(buf)
            buf = []
    if buf:
        yield np.stack(buf)


def process_video(frames: Union[np.ndarray, Iterable[np.ndarray]], fn: Callable, *,
                  batch_size: int = 32, mesh=None,
                  preprocess: Optional[Callable] = None,
                  device: Union[None, str, torch.device] = None) -> np.ndarray:
    """Map ``fn(batch (B, H, W, ...) tensor) -> (B, ...) tensor`` over every
    frame of a video on ``device`` (the card unless the CPU is asked for).

    ``frames`` is an array or any frame iterator (such as :func:`iter_y4m`'s).
    Each batch is padded to ``batch_size`` by repeating its last frame
    (trimmed after), passed through ``preprocess`` on the host, staged in
    one of two pinned buffers and copied without blocking, then ``fn`` is
    launched; batch k - 1's result is read back only after batch k is
    launched, so the host's decoding and copying of the next batch overlap
    the device's work. Returns the stacked results (T, ...) as numpy.
    ``mesh`` (sharding each batch over several devices) is not ported and
    raises."""
    if mesh is not None:
        raise NotImplementedError(
            "process_video: a mesh (each batch sharded over several devices) is not ported "
            "yet; it runs on one device (scale-out, P15 in ROADMAP.md)")
    dev = resolve_device(device)
    pinned = [None, None]

    def dispatch(k: int, batch: np.ndarray):
        real = batch.shape[0]
        if real < batch_size:
            batch = np.concatenate([batch, np.repeat(batch[-1:], batch_size - real, axis=0)])
        if preprocess is not None:
            batch = preprocess(batch)
        host = torch.from_numpy(np.ascontiguousarray(batch))
        if dev.type == "cuda":
            if pinned[k % 2] is None or pinned[k % 2].shape != host.shape \
                    or pinned[k % 2].dtype != host.dtype:
                pinned[k % 2] = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
            pinned[k % 2].copy_(host)
            host = pinned[k % 2]
        return fn(host.to(dev, non_blocking=True)), real

    outs, pending = [], None
    for k, chunk in enumerate(_chunks(frames, batch_size)):
        launched = dispatch(k, chunk)
        if pending is not None:
            y, real = pending
            outs.append(y.detach().cpu().numpy()[:real])     # waits for batch k - 1 only
        pending = launched
    if pending is None:
        raise ValueError("process_video: no frames")
    y, real = pending
    outs.append(y.detach().cpu().numpy()[:real])
    return np.concatenate(outs)


# --------------------------------------------------------------------------- #
# The .dvv container
# --------------------------------------------------------------------------- #

_DVV_FILE_MAGIC = b"DCVF"


def write_dvv(path: Union[str, Path], clips: Iterable[np.ndarray], codec,
              ) -> int:
    """Compress clips through a fitted
    :class:`~deepcv_tpu_torch.codec.LosslessVideoCodec` into a container
    file. Layout: magic | u8 n_scales | u16 H W | u8 C | per clip: u32
    length + codec stream. Returns the number of clips written; one clip
    is encoded and written at a time."""
    h, w, c = codec.frame_shape
    n = 0
    with open(path, "wb") as f:
        f.write(_DVV_FILE_MAGIC)
        f.write(struct.pack("<BHHB", codec.intra.n_scales, h, w, c))
        for clip in clips:
            blob = codec.encode_clip(np.asarray(clip, np.uint8))
            f.write(struct.pack("<I", len(blob)))
            f.write(blob)
            n += 1
    return n


def iter_dvv(path: Union[str, Path], codec) -> Iterator[np.ndarray]:
    """Stream decoded (T, H, W, C) uint8 clips from a .dvv container."""
    with open(path, "rb") as f:
        if f.read(4) != _DVV_FILE_MAGIC:
            raise ValueError("not a deepcv video container")
        n_scales, h, w, c = struct.unpack("<BHHB", f.read(6))
        if ((h, w, c) != tuple(codec.frame_shape)
                or n_scales != codec.intra.n_scales):
            raise ValueError(f"container is {h}x{w}x{c}/{n_scales} scales; "
                             f"codec is {codec.frame_shape}/"
                             f"{codec.intra.n_scales}")
        while True:
            head = f.read(4)
            if not head:
                return
            if len(head) != 4:
                raise ValueError("truncated .dvv container (cut inside a "
                                 "clip length prefix)")
            (ln,) = struct.unpack("<I", head)
            blob = f.read(ln)
            if len(blob) != ln:
                raise ValueError(f"truncated .dvv container (clip needs "
                                 f"{ln} bytes, {len(blob)} present)")
            yield codec.decode_clip(blob)


def read_dvv(path: Union[str, Path], codec) -> np.ndarray:
    """Read a whole .dvv container -> (N, T, H, W, C) uint8 (clips must
    share one length; use :func:`iter_dvv` for ragged clips)."""
    clips = list(iter_dvv(path, codec))
    if not clips:
        raise ValueError(f"no clips in {path}")
    return np.stack(clips)
