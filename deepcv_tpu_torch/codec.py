"""The learned lossless image codec (L3C-style hierarchical context
modelling), its video extension, and their range-coded bitstreams.

Counterpart of ``deepcv_tpu/codec.py`` (``quantize_cdf``, ``LosslessCodec``,
``LosslessVideoCodec``):

  * The image forms a SUBSAMPLE PYRAMID: level ``l+1`` is level ``l``'s
    top-left 2x2 phase, so the coarsest level plus three "detail" phases
    per level reconstruct the image exactly.
  * A small CNN per phase (:class:`PhaseNet`, shared across levels)
    predicts a 256-way distribution for every detail subpixel from the
    already-known planes: phase 1 sees the coarse plane, phase 2 coarse and
    phase 1, phase 3 all three. A phase is one batched forward on the card.
  * Training minimises the code length, the mean negative log2-likelihood
    in bits per subpixel (AdamW, the JAX package's optax ``adamw``: weight
    decay 1e-4); the range coder (:mod:`deepcv_tpu_torch.runtime.range_coder`)
    realises that rate to within a few bytes a block.

The models are ``nn.Module`` subclasses on NCHW tensors whose parameters are named
by the JAX variables' paths (``phase<i>.Conv_<j>.weight``, ``jax_flat``), so
:func:`deepcv_tpu_torch.interop.load_jax_variables` carries the flax
``phase<i>/Conv_<j>`` parameters across; the phase net's ``C * 256`` output
channels split as flax's ``(..., C, 256)`` does, channel-major. The
bitstream layout is the JAX package's.

Coding is deterministic where it must be: the probability model always runs
at the fixed ``coding_batch`` (the tail tiled with its last real row),
softmax is taken in float32 on the device and widened to float64 on the
host, and every forward runs with TF32 off and cuDNN deterministic with its
autotuner off, so that encoder and decoder pick the same algorithms and
build identical CDF tables. As in the JAX package, a stream decodes with the
same parameters on the device kind that encoded it: another device may round
a logit differently across a CDF quantisation step and desynchronise the
coder. The parameters are drawn from a ``torch.Generator`` seeded with
``seed`` (flax's LeCun-normal kernels, zero biases); JAX's draws are not
reproduced, so a model trained here and one trained there from the same
seed differ.
"""
from __future__ import annotations

import contextlib
import struct
import zlib
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from deepcv_tpu_torch.ops.nn import lecun_normal_
from deepcv_tpu_torch.runtime.range_coder import TOTAL, rc_decode, rc_encode
from deepcv_tpu_torch.train.optimizers import build_optimizer
from deepcv_tpu_torch.utils import resolve_device

__all__ = ["LosslessCodec", "LosslessVideoCodec", "PhaseNet", "PyramidModel", "quantize_cdf",
           "png_bytes"]

_MAGIC = b"DCVC"
#: detail-phase offsets within each 2x2 cell; (0, 0) is the coarse phase
_PHASES = ((0, 1), (1, 0), (1, 1))
#: optax ``adamw``'s default weight decay, which the JAX codec trains with
ADAMW_WEIGHT_DECAY = 1e-4


def quantize_cdf(probs: np.ndarray) -> np.ndarray:
    """float probabilities (N, K) -> uint32 CDF rows (N, K+1), total 2^16,
    every symbol >= 1/2^16 (the coder cannot represent zero mass).
    Deterministic — encoder and decoder MUST build identical tables."""
    p = np.asarray(probs, np.float64)
    n, k = p.shape
    p = np.maximum(p, 1e-12)
    p /= p.sum(axis=1, keepdims=True)
    f = np.floor(p * (TOTAL - k)).astype(np.uint32) + 1     # sum <= TOTAL
    f[np.arange(n), p.argmax(axis=1)] += (TOTAL - f.sum(axis=1)).astype(np.uint32)
    cdf = np.zeros((n, k + 1), dtype=np.uint32)
    np.cumsum(f, axis=1, out=cdf[:, 1:], dtype=np.uint32)
    return cdf


@contextlib.contextmanager
def deterministic_math():
    """TF32 off for convolutions and matmuls, cuDNN deterministic with its
    autotuner off; every flag restored on exit."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    prev = (cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic, cudnn.benchmark)
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic, cudnn.benchmark = prev


class PhaseNet(nn.Module):
    """Context CNN for one detail phase: known planes (NCHW float) ->
    per-pixel, per-channel logits (B, h, w, C, symbols). Two 3x3 convs
    with relu and a 1x1, 'SAME' padding (flax's ``_PhaseNet``)."""

    def __init__(self, in_channels: int, channels: int, hidden: int, symbols: int):
        super().__init__()
        self.channels, self.symbols = int(channels), int(symbols)
        self.Conv_0 = nn.Conv2d(in_channels, hidden, 3, padding=1)
        self.Conv_1 = nn.Conv2d(hidden, hidden, 3, padding=1)
        self.Conv_2 = nn.Conv2d(hidden, channels * symbols, 1)

    def init_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            for conv in (self.Conv_0, self.Conv_1, self.Conv_2):
                lecun_normal_(conv.weight, generator)
                conv.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.Conv_0(x))
        h = F.relu(self.Conv_1(h))
        h = self.Conv_2(h).permute(0, 2, 3, 1)               # (B, h, w, C * S)
        return h.reshape(*h.shape[:3], self.channels, self.symbols)


class PyramidModel(nn.Module):
    """One :class:`PhaseNet` per detail phase, shared across scales; their
    inputs have C (coarse), 2C and 3C channels."""

    jax_flat = True

    def __init__(self, channels: int, hidden: int, symbols: int, n_scales: int):
        super().__init__()
        self.channels, self.symbols, self.n_scales = int(channels), int(symbols), int(n_scales)
        for i in range(3):
            self.add_module(f"phase{i}", PhaseNet((i + 1) * channels, channels, hidden,
                                                  symbols))

    def _norm(self, u8: torch.Tensor) -> torch.Tensor:
        return u8.to(torch.float32) / (self.symbols - 1) * 2.0 - 1.0

    def phase_logits(self, known: Sequence[torch.Tensor], phase: int) -> torch.Tensor:
        """known: uint8 planes (B, h, w, C), coarse first, then the phases
        coded so far -> (B, h, w, C, symbols) logits."""
        x = torch.cat([self._norm(k) for k in known], dim=-1).permute(0, 3, 1, 2)
        return getattr(self, f"phase{phase}")(x)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """Total model code length in bits of the detail subpixels of every
        level for a uint8 (B, H, W, C) batch (the coarsest level is stored
        raw, 8 bits a subpixel, and not counted)."""
        x = images
        bits = torch.zeros((), dtype=torch.float32, device=images.device)
        for _ in range(self.n_scales):
            coarse = x[:, 0::2, 0::2, :]
            known = [coarse]
            for p, (dy, dx) in enumerate(_PHASES):
                target = x[:, dy::2, dx::2, :]
                logp = torch.log_softmax(self.phase_logits(known, p), dim=-1)
                nll = -torch.gather(logp, -1, target.long()[..., None])
                bits = bits + nll.sum() / np.float32(np.log(2.0))
                known.append(target)
            x = coarse
        return bits


class LosslessCodec:
    """Train-encode-decode facade over the pyramid model and the range
    coder, on ``device`` (CUDA unless given). ``encode`` and ``decode`` are
    exact inverses; the realised size tracks :meth:`bits_per_dim` to the
    coder's overhead (about 4 bytes a phase block)."""

    def __init__(self, image_shape: Tuple[int, int, int], *, n_scales: int = 2,
                 hidden: int = 32, symbols: int = 256, seed: int = 0,
                 coding_batch: int = 16, device: Union[None, str, torch.device] = None):
        h, w, c = image_shape
        if h % (1 << n_scales) or w % (1 << n_scales):
            raise ValueError(f"image dims {h}x{w} must be divisible by "
                             f"2^n_scales = {1 << n_scales}")
        self.device = resolve_device(device)
        self.image_shape = (h, w, c)
        self.n_scales = int(n_scales)
        self.symbols = int(symbols)
        self._coding_batch = max(1, int(coding_batch))
        self.model = PyramidModel(c, hidden, symbols, self.n_scales)
        gen = torch.Generator().manual_seed(int(seed))
        for net in self.model.children():
            net.init_parameters(gen)
        self.model.to(self.device)

    @property
    def native_coder(self) -> bool:
        """Whether the range coder runs natively (else the Python mirror)."""
        from deepcv_tpu_torch.runtime.range_coder import rc_native_available
        return rc_native_available()

    def _tensor(self, images: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(images, np.uint8)).to(self.device)

    # ------------------------------------------------------------ training
    def fit(self, images: np.ndarray, *, steps: int = 300, batch_size: int = 16,
            lr: float = 3e-3, seed: int = 0, log_every: int = 0) -> List[float]:
        """MLE training: minimise the mean bits a subpixel of the detail
        phases; batches drawn without replacement by
        ``numpy.random.default_rng(seed).choice``, as in the JAX package.
        Returns the loss of every step."""
        h, w, c = self.image_shape
        opt = build_optimizer("adamw", {"lr": lr, "weight_decay": ADAMW_WEIGHT_DECAY},
                              self.model.parameters())
        eff_batch = min(batch_size, len(images))
        denom = eff_batch * h * w * c
        rng = np.random.default_rng(seed)
        images = np.asarray(images, np.uint8)
        losses = []
        self.model.train()
        with deterministic_math():
            for i in range(steps):
                idx = rng.choice(len(images), size=eff_batch, replace=False)
                loss = self.model(self._tensor(images[idx])) / denom
                opt.zero_grad(set_to_none=True)
                loss.backward()
                opt.step()
                losses.append(loss.detach())
                if log_every and (i + 1) % log_every == 0:
                    print(f"codec step {i + 1}/{steps}: {float(losses[-1]):.3f} bits/subpixel")
        return [float(v) for v in torch.stack(losses).cpu()] if losses else []

    # ------------------------------------------------------------ rate math
    def bits_per_dim(self, images: np.ndarray) -> float:
        """Model rate in bits a subpixel, the raw coarsest level included."""
        images = np.asarray(images, np.uint8)
        h, w, c = self.image_shape
        top = (h >> self.n_scales) * (w >> self.n_scales) * c * 8 * len(images)
        with torch.no_grad(), deterministic_math():
            bits = float(self.model(self._tensor(images)))
        return (bits + top) / images.size

    # ------------------------------------------------------------ coding
    def _phase_cdf(self, known: List[np.ndarray], phase: int) -> np.ndarray:
        """known: batched uint8 planes (B, h, w, C) -> per-image CDF rows
        (B, h*w*C, K+1). The model always runs at the fixed batch
        ``coding_batch`` (the tail tiled with the last real row), so that
        encoder and decoder run the same convolutions whatever batch each
        caller codes: another batch could pick another algorithm, round a
        logit differently across a CDF step and desynchronise the coder."""
        b = known[0].shape[0]
        cb = self._coding_batch
        prob_rows = []
        with torch.no_grad(), deterministic_math():
            for start in range(0, b, cb):
                chunk = [k[start:start + cb] for k in known]
                pad = cb - chunk[0].shape[0]
                if pad:
                    chunk = [np.concatenate([k, np.repeat(k[-1:], pad, axis=0)])
                             for k in chunk]
                logits = self.model.phase_logits([self._tensor(k) for k in chunk], phase)
                probs = torch.softmax(logits.float(), dim=-1).cpu().numpy().astype(np.float64)
                prob_rows.append(probs[:cb - pad] if pad else probs)
        probs = np.concatenate(prob_rows)
        return quantize_cdf(probs.reshape(-1, self.symbols)).reshape(b, -1, self.symbols + 1)

    def encode(self, image: np.ndarray) -> bytes:
        """uint8 (H, W, C) -> bitstream. Layout: magic | n_scales | raw
        coarsest level | per level (coarse->fine), per phase:
        u32 length + range-coded block."""
        return self.encode_batch(np.asarray(image, np.uint8)[None])[0]

    def encode_batch(self, images: np.ndarray) -> List[bytes]:
        """Encode (B, H, W, C): per-image bitstreams identical to
        :meth:`encode`'s, but every phase's probabilities come from one
        batched forward."""
        images = np.ascontiguousarray(images, np.uint8)
        if images.shape[1:] != self.image_shape:
            raise ValueError(f"expected {self.image_shape}, got {images.shape[1:]}")
        levels = [images]
        for _ in range(self.n_scales):
            levels.append(levels[-1][:, 0::2, 0::2, :])
        header = _MAGIC + struct.pack("<BHHB", self.n_scales, *self.image_shape)
        outs = [[header, top.tobytes()] for top in levels[-1]]
        for lvl in range(self.n_scales - 1, -1, -1):
            known = [levels[lvl + 1]]
            for p, (dy, dx) in enumerate(_PHASES):
                target = levels[lvl][:, dy::2, dx::2, :]
                cdf = self._phase_cdf(known, p)
                for i, out in enumerate(outs):
                    blob = rc_encode(target[i].reshape(-1).astype(np.uint16),
                                     cdf[i])
                    out.append(struct.pack("<I", len(blob)))
                    out.append(blob)
                known.append(target)
        return [b"".join(out) for out in outs]

    def decode(self, data: bytes) -> np.ndarray:
        return self.decode_batch([data])[0]

    def _decode_levels(self, streams: Sequence[bytes]):
        """Sequential decode, one completed pyramid level at a time.

        Yields ``(level, planes (B, H>>level, W>>level, C), bytes_consumed
        per stream)`` after the raw coarsest level and after each coded
        level completes — the engine behind both :meth:`decode_batch` and
        the progressive-loading surface (the bitstream is coarse->fine, so
        every yield depends only on a PREFIX of the stream)."""
        h, w, c = self.image_shape
        positions = []
        for data in streams:
            if data[:4] != _MAGIC:
                raise ValueError("not a deepcv codec stream")
            meta = struct.unpack_from("<BHHB", data, 4)
            if meta != (self.n_scales, h, w, c):
                raise ValueError(f"stream is {meta[1]}x{meta[2]}x{meta[3]}/"
                                 f"{meta[0]} scales; codec is "
                                 f"{self.image_shape}/{self.n_scales}")
            positions.append(4 + struct.calcsize("<BHHB"))
        b = len(streams)
        th, tw = h >> self.n_scales, w >> self.n_scales
        top_n = th * tw * c
        x = np.stack([np.frombuffer(s, np.uint8, top_n, positions[i])
                      .reshape(th, tw, c) for i, s in enumerate(streams)])
        positions = [pos + top_n for pos in positions]
        yield self.n_scales, x, list(positions)
        for lvl in range(self.n_scales - 1, -1, -1):
            hh, ww = h >> lvl, w >> lvl
            fine = np.zeros((b, hh, ww, c), np.uint8)
            fine[:, 0::2, 0::2, :] = x
            known = [x]
            for p, (dy, dx) in enumerate(_PHASES):
                cdf = self._phase_cdf(known, p)
                plane = np.empty((b, hh // 2, ww // 2, c), np.uint8)
                for i, s in enumerate(streams):
                    (ln,) = struct.unpack_from("<I", s, positions[i])
                    positions[i] += 4
                    syms = rc_decode(s[positions[i]:positions[i] + ln],
                                     cdf.shape[1], cdf[i])
                    positions[i] += ln
                    plane[i] = syms.astype(np.uint8).reshape(hh // 2, ww // 2, c)
                fine[:, dy::2, dx::2, :] = plane
                known.append(plane)
            x = fine
            yield lvl, x, list(positions)

    def decode_batch(self, streams: Sequence[bytes]) -> np.ndarray:
        """Decode same-shape bitstreams; phase CNNs batch across streams
        (decoding stays sequential only across phases, as it must)."""
        for _, x, _ in self._decode_levels(streams):
            pass
        return x

    def decode_progressive(self, data: bytes):
        """Progressive loading (the reference codec TODO's 'possibility of
        progressive image/frame loading/streaming', README.md:159): yields
        ``{'level', 'scale', 'image', 'bytes_consumed', 'final'}`` after
        each pyramid level, coarse to fine. ``image`` is always full
        resolution (nearest-upsampled preview; the last yield is the exact
        decode), so a UI can paint every yield in place. Each preview
        consumed only the stream PREFIX reported in ``bytes_consumed``."""
        for lvl, x, pos in self._decode_levels([data]):
            s = 1 << lvl
            preview = np.repeat(np.repeat(x[0], s, axis=0), s, axis=1)
            yield {"level": lvl, "scale": s, "image": preview,
                   "bytes_consumed": pos[0], "final": lvl == 0}

    def _finest_complete_level(self, data: bytes) -> int:
        """Walk the length-prefixed block layout (no decoding) and return
        the finest level whose bytes are FULLY present in ``data``."""
        h, w, c = self.image_shape
        pos = (4 + struct.calcsize("<BHHB")
               + (h >> self.n_scales) * (w >> self.n_scales) * c)
        if len(data) < pos:
            raise ValueError("truncated before the coarsest level "
                             f"({len(data)} bytes)")
        complete = self.n_scales
        for lvl in range(self.n_scales - 1, -1, -1):
            for _ in _PHASES:
                if pos + 4 > len(data):
                    return complete
                (ln,) = struct.unpack_from("<I", data, pos)
                pos += 4 + ln
                if pos > len(data):
                    return complete
            complete = lvl
        return complete

    def decode_partial(self, data: bytes) -> Tuple[np.ndarray, int]:
        """Best full-resolution preview from a possibly TRUNCATED stream —
        the streaming story: a byte prefix renders at the finest level it
        fully contains. Returns (preview uint8 (H, W, C), finest completed
        level; 0 = exact full decode). Raises on a stream too short for
        even the raw coarsest level. The lazy level generator stops AT the
        last complete level, so the truncated tail is never parsed."""
        target = self._finest_complete_level(data)
        for out in self.decode_progressive(data):
            if out["level"] == target:
                return out["image"], out["level"]
        raise AssertionError("unreachable: target level not yielded")

    # ------------------------------------------------------------ benchmark
    def evaluate(self, images: np.ndarray, *, n_code: int = 4) -> Dict[str, float]:
        """Honest rate report: model bits/dim over ``images``, REALIZED
        bytes for the first ``n_code`` images, and PNG + raw baselines."""
        images = np.asarray(images, np.uint8)
        bpd = self.bits_per_dim(images)
        sizes = [len(s) for s in self.encode_batch(images[:n_code])]
        png_sizes = [png_bytes(img) for img in images[:n_code]]
        per_image = int(np.prod(self.image_shape))
        out = {"bits_per_dim": bpd, "raw_bits_per_dim": 8.0,
               "coded_bits_per_dim": float(np.mean(sizes)) * 8 / per_image,
               "coded_bytes_mean": float(np.mean(sizes))}
        if png_sizes:
            out["png_bytes_mean"] = float(np.mean(png_sizes))
            out["vs_png"] = out["png_bytes_mean"] / out["coded_bytes_mean"]
        return out


def png_bytes(img: np.ndarray) -> int:
    """Size of ``img`` (H, W, 1 or 3 uint8) as a PNG, the lossless baseline:
    written here with the standard library (zlib at level 9 and, per row,
    the filter of least absolute sum, libpng's heuristic), so it needs no
    imaging package; the JAX package measures PIL's ``optimize=True``."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    bpp = c
    rows = img.reshape(h, w * c).astype(np.int16)
    prev = np.zeros(w * c, np.int16)
    out = bytearray()
    for r in range(h):
        cur = rows[r]
        left = np.concatenate([np.zeros(bpp, np.int16), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int16), prev[:-bpp]])
        p = left + prev - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        cands = [cur, cur - left, cur - prev, cur - ((left + prev) >> 1), cur - paeth]
        filt = [(v & 0xFF).astype(np.uint8) for v in cands]
        cost = [int(np.abs(f.view(np.int8).astype(np.int32)).sum()) for f in filt]
        best = int(np.argmin(cost))
        out.append(best)
        out += filt[best].tobytes()
        prev = cur

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    color = {1: 0, 3: 2}[c]
    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(bytes(out), 9)) + chunk(b"IEND", b""))
    return len(png)


# --------------------------------------------------------------------------- #
class LosslessVideoCodec:
    """Lossless video codec: per-frame intra/inter over two pyramid models.

    ``encode_clip``/``decode_clip`` are exact inverses for (T, H, W, C)
    uint8 clips. Frame 0 is always intra (the image codec); a later frame
    takes the smaller of its intra stream and the stream of its modulo-256
    temporal residual through a second pyramid model trained on residuals
    (a bijection, so inter frames reconstruct exactly from the previous
    decoded frame); a 1-byte flag a frame tells the decoder.
    """

    _VMAGIC = b"DCVV"

    def __init__(self, frame_shape: Tuple[int, int, int], *, n_scales: int = 2,
                 hidden: int = 32, symbols: int = 256, seed: int = 0,
                 coding_batch: int = 16, device: Union[None, str, torch.device] = None):
        self.frame_shape = tuple(frame_shape)
        self.intra = LosslessCodec(frame_shape, n_scales=n_scales,
                                   hidden=hidden, symbols=symbols, seed=seed,
                                   coding_batch=coding_batch, device=device)
        self.inter = LosslessCodec(frame_shape, n_scales=n_scales,
                                   hidden=hidden, symbols=symbols,
                                   seed=seed + 1, coding_batch=coding_batch, device=device)

    @staticmethod
    def _residuals(clips: np.ndarray) -> np.ndarray:
        c = clips.astype(np.int16)
        return ((c[:, 1:] - c[:, :-1]) % 256).astype(np.uint8)

    def fit(self, clips: np.ndarray, *, steps: int = 300, batch_size: int = 16,
            lr: float = 3e-3, seed: int = 0, log_every: int = 0
            ) -> Dict[str, List[float]]:
        """Train the intra model on frames and the inter model on temporal
        residuals of ``clips`` (N, T, H, W, C) uint8."""
        clips = np.asarray(clips, np.uint8)
        if clips.ndim != 5 or clips.shape[1] < 2:
            raise ValueError(f"expected (N, T>=2, H, W, C) clips, got "
                             f"{clips.shape}")
        frames = clips.reshape((-1,) + clips.shape[2:])
        res = self._residuals(clips).reshape((-1,) + clips.shape[2:])
        return {"intra": self.intra.fit(frames, steps=steps,
                                        batch_size=batch_size, lr=lr,
                                        seed=seed, log_every=log_every),
                "inter": self.inter.fit(res, steps=steps,
                                        batch_size=batch_size, lr=lr,
                                        seed=seed + 1, log_every=log_every)}

    def encode_clip(self, clip: np.ndarray) -> bytes:
        """(T, H, W, C) uint8 -> bitstream. Layout: magic | u16 T | per
        frame: u8 mode (0=intra, 1=inter) + u32 length + image-codec
        stream."""
        clip = np.ascontiguousarray(clip, np.uint8)
        if clip.ndim != 4 or clip.shape[1:] != self.frame_shape:
            raise ValueError(f"expected (T, *{self.frame_shape}) clip, got "
                             f"{clip.shape}")
        t = clip.shape[0]
        intra_streams = self.intra.encode_batch(clip)
        inter_streams = self.inter.encode_batch(
            self._residuals(clip[None])[0]) if t > 1 else []
        out = [self._VMAGIC, struct.pack("<H", t)]
        for i in range(t):
            s_intra = intra_streams[i]
            s_inter = inter_streams[i - 1] if i > 0 else None
            if s_inter is not None and len(s_inter) < len(s_intra):
                mode, stream = 1, s_inter
            else:
                mode, stream = 0, s_intra
            out.append(struct.pack("<BI", mode, len(stream)))
            out.append(stream)
        return b"".join(out)

    def decode_clip(self, data: bytes) -> np.ndarray:
        if data[:4] != self._VMAGIC:
            raise ValueError("not a deepcv video codec stream")
        (t,) = struct.unpack_from("<H", data, 4)
        pos = 6
        modes, streams = [], []
        for _ in range(t):
            mode, length = struct.unpack_from("<BI", data, pos)
            pos += 5
            streams.append(data[pos:pos + length])
            modes.append(mode)
            pos += length
        if modes and modes[0] != 0:
            raise ValueError("corrupt stream: first frame must be intra")
        # batch the per-model decodes (decode cost is phase-sequential, so
        # grouping same-model streams keeps one dispatch per phase)
        intra_idx = [i for i, m in enumerate(modes) if m == 0]
        inter_idx = [i for i, m in enumerate(modes) if m == 1]
        planes: Dict[int, np.ndarray] = {}
        if intra_idx:
            dec = self.intra.decode_batch([streams[i] for i in intra_idx])
            planes.update(zip(intra_idx, dec))
        if inter_idx:
            dec = self.inter.decode_batch([streams[i] for i in inter_idx])
            planes.update(zip(inter_idx, dec))
        frames = np.zeros((t,) + self.frame_shape, np.uint8)
        for i in range(t):
            if modes[i] == 0:
                frames[i] = planes[i]
            else:  # inter: previous DECODED frame + wrapped residual
                frames[i] = ((frames[i - 1].astype(np.int16)
                              + planes[i].astype(np.int16)) % 256
                             ).astype(np.uint8)
        return frames

    def evaluate(self, clips: np.ndarray, *, n_code: int = 2
                 ) -> Dict[str, float]:
        """Realized rate report over the first ``n_code`` clips: coded
        bits/subpixel, intra-only baseline, inter-mode share."""
        clips = np.asarray(clips, np.uint8)
        per_clip = int(np.prod(clips.shape[1:]))
        sizes, intra_sizes, inter_frames, total_frames = [], [], 0, 0
        for clip in clips[:n_code]:
            blob = self.encode_clip(clip)
            sizes.append(len(blob))
            intra_sizes.append(sum(len(s)
                                   for s in self.intra.encode_batch(clip)))
            (t,) = struct.unpack_from("<H", blob, 4)
            pos = 6
            for _ in range(t):
                mode, length = struct.unpack_from("<BI", blob, pos)
                inter_frames += int(mode == 1)
                total_frames += 1
                pos += 5 + length
        return {"coded_bits_per_dim": float(np.mean(sizes)) * 8 / per_clip,
                "intra_only_bits_per_dim":
                    float(np.mean(intra_sizes)) * 8 / per_clip,
                "inter_frame_share": inter_frames / max(1, total_frames)}
