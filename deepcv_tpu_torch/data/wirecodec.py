"""The wire codec of the streaming input path: fewer bytes from the host to
the card, decoded on the card.

Counterpart of ``deepcv_tpu/data/wirecodec.py`` (``encode_u8``,
``decode_u8``, ``device_decode``, ``wire_bytes``). The scheme, for uint8
batches:

  delta (along a chosen axis, mod 256) -> zigzag -> ``bits``-bit base
  codes where the all-ones code is an ESCAPE -> escaped values go to a
  dense 1-byte overflow stream in position order (no indices on the wire).

:func:`encode_u8` runs on the host in numpy and gives the JAX package's
payload byte for byte, with one difference: it ships a batch coded only when
the bytes it actually sends (the packed codes, whose 3-bit groups pad to 3
bytes, plus the overflow bucket) are fewer than the raw ones. The JAX
package tests the unpadded ``ceil(n * bits / 8)`` instead, so at ``bits=3``
it can ship a few bytes more than raw (105 bytes with at most 64 escapes:
42 + 64 = 106); here such a batch goes raw. The overflow stream is padded to
a power-of-two bucket of at least 64 bytes, as there.

:func:`decode_u8` decodes on tensors, wherever they are: the codes are
unpacked in int32 (bitwise ops and shifts on ``torch.uint32`` are incomplete
on CUDA), the i-th escape takes the i-th overflow byte by a ``cumsum`` of
the escapes, the zigzag is undone and one ``cumsum`` along the axis, taken
mod 256, integrates the deltas. :func:`device_decode` copies the payload from
pinned memory to the card and decodes it there.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from deepcv_tpu_torch.utils import resolve_device

__all__ = ["encode_u8", "decode_u8", "device_decode", "wire_bytes", "packed_bytes"]

_SUPPORTED_BITS = (2, 3, 4)
_MIN_OVERFLOW_BUCKET = 64

# zigzag of the mod-256 delta byte, as a table: _ZIGZAG_LUT[d] =
# (s << 1) ^ (s >> 7) for s = d as int8 — 0,-1,1,-2,... -> 0,1,2,3,...
_s = np.arange(256, dtype=np.uint8).view(np.int8).astype(np.int16)
_ZIGZAG_LUT = (((_s << 1) ^ (_s >> 7)) & 0xFF).astype(np.uint8)
del _s


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length())


def _pack_bits(codes: np.ndarray, bits: int) -> np.ndarray:
    """Pack ``bits``-bit codes little-endian into bytes (host side)."""
    if bits in (2, 4):
        group = 8 // bits
        pad = (-len(codes)) % group
        c = np.concatenate([codes, np.zeros(pad, np.uint8)]).reshape(-1, group)
        out = np.zeros(c.shape[0], np.uint8)
        for g in range(group):
            out |= c[:, g] << np.uint8(g * bits)
        return out
    # bits=3: 8 codes -> 3 bytes (v0..v7 laid out little-endian in 24 bits)
    pad = (-len(codes)) % 8
    v = np.concatenate([codes, np.zeros(pad, np.uint8)]) \
        .reshape(-1, 8).astype(np.uint32)
    word = np.zeros(v.shape[0], np.uint32)
    for g in range(8):
        word |= v[:, g] << np.uint32(3 * g)
    out = np.empty((v.shape[0], 3), np.uint8)
    out[:, 0] = word & 0xFF
    out[:, 1] = (word >> 8) & 0xFF
    out[:, 2] = (word >> 16) & 0xFF
    return out.reshape(-1)


def packed_bytes(n: int, bits: int) -> int:
    """Bytes that ``n`` codes of ``bits`` bits take once packed: 8 // bits
    codes a byte for 2 and 4 bits, 8 codes in 3 bytes for 3."""
    if bits == 3:
        return 3 * (-(-n // 8))
    return -(-n // (8 // bits))


def _pack_bits(codes: np.ndarray, bits: int) -> np.ndarray:
    """Pack ``bits``-bit codes little-endian into bytes (host side)."""
    if bits in (2, 4):
        group = 8 // bits
        pad = (-len(codes)) % group
        c = np.concatenate([codes, np.zeros(pad, np.uint8)]).reshape(-1, group)
        out = np.zeros(c.shape[0], np.uint8)
        for g in range(group):
            out |= c[:, g] << np.uint8(g * bits)
        return out
    # bits=3: 8 codes -> 3 bytes (v0..v7 laid out little-endian in 24 bits)
    pad = (-len(codes)) % 8
    v = np.concatenate([codes, np.zeros(pad, np.uint8)]).reshape(-1, 8).astype(np.uint32)
    word = np.zeros(v.shape[0], np.uint32)
    for g in range(8):
        word |= v[:, g] << np.uint32(3 * g)
    out = np.empty((v.shape[0], 3), np.uint8)
    out[:, 0] = word & 0xFF
    out[:, 1] = (word >> 8) & 0xFF
    out[:, 2] = (word >> 16) & 0xFF
    return out.reshape(-1)


def encode_u8(x: np.ndarray, bits: int = 4, axis: int = -2) -> Optional[Dict[str, np.ndarray]]:
    """Encode a uint8 array for the wire; None when the coded payload would
    not be smaller than the raw array (the caller ships it raw).

    ``axis`` is the delta axis: the image row (W) for NHWC batches, so
    smooth horizontal structure turns into near-zero deltas. The payload
    holds ``packed`` and ``overflow`` (uint8 arrays) and the ``shape``,
    ``bits`` and ``axis`` the decoder needs."""
    if bits not in _SUPPORTED_BITS:
        raise ValueError(f"bits must be one of {_SUPPORTED_BITS}, got {bits}")
    x = np.asarray(x)
    if x.dtype != np.uint8:
        raise ValueError(f"wire codec is for uint8 feeds, got {x.dtype}")
    axis = axis % x.ndim
    # mod-256 delta along the axis; the first element keeps its raw value
    d = x.copy()
    hi = [slice(None)] * x.ndim
    lo = [slice(None)] * x.ndim
    hi[axis] = slice(1, None)
    lo[axis] = slice(None, -1)
    d[tuple(hi)] = x[tuple(hi)] - x[tuple(lo)]
    z = _ZIGZAG_LUT[d.reshape(-1)]
    n = z.size
    escape = np.uint8((1 << bits) - 1)
    esc_mask = z >= escape
    overflow = z[esc_mask]
    bucket = max(_MIN_OVERFLOW_BUCKET, _next_pow2(len(overflow)))
    if packed_bytes(n, bits) + bucket >= n:   # not smaller than raw: ship raw
        return None
    # escape is the largest base code, so clipping is the escape substitution
    packed = _pack_bits(np.minimum(z, escape), bits)
    overflow = np.concatenate([overflow, np.zeros(bucket - len(overflow), np.uint8)])
    return {"packed": packed, "overflow": overflow, "shape": tuple(x.shape), "bits": bits,
            "axis": axis}


def wire_bytes(payload: Optional[Dict[str, np.ndarray]]) -> int:
    """Bytes this payload puts on the host-to-device wire (0 for None)."""
    if payload is None:
        return 0
    return payload["packed"].nbytes + payload["overflow"].nbytes


def decode_u8(packed: torch.Tensor, overflow: torch.Tensor, shape, bits: int,
              axis: int) -> torch.Tensor:
    """The uint8 array of ``shape`` from its payload tensors (uint8, on any
    device); the result lies where ``packed`` lies."""
    n = int(np.prod(shape))
    mask = (1 << bits) - 1
    if bits in (2, 4):
        shifts = torch.arange(8 // bits, device=packed.device, dtype=torch.int32) * bits
        base = (packed.to(torch.int32)[:, None] >> shifts[None, :]) & mask
    else:   # 3 bytes -> 8 codes through one little-endian 24-bit word
        b = packed.reshape(-1, 3).to(torch.int32)
        word = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
        shifts = torch.arange(8, device=packed.device, dtype=torch.int32) * 3
        base = (word[:, None] >> shifts[None, :]) & mask
    base = base.reshape(-1)[:n]
    esc = base == mask
    # the i-th escape position (in order) takes the i-th overflow byte
    ranks = (torch.cumsum(esc.to(torch.int32), 0) - 1).clamp_(0, overflow.shape[0] - 1)
    z = torch.where(esc, overflow.to(torch.int32)[ranks], base)
    d = ((z >> 1) ^ -(z & 1)) & 0xFF                    # un-zigzag, mod 256
    # integrate along the delta axis; mod 256 distributes over the running sum
    x = torch.cumsum(d.reshape(shape), dim=axis) & 0xFF
    return x.to(torch.uint8)


def device_decode(payload: Dict[str, np.ndarray],
                  device: Union[None, str, torch.device] = None) -> torch.Tensor:
    """Copy ``packed`` and ``overflow`` to ``device`` (CUDA unless given)
    from pinned memory and decode them there."""
    device = resolve_device(device)
    parts = [torch.from_numpy(np.ascontiguousarray(payload[k])) for k in ("packed", "overflow")]
    if device.type == "cuda":
        parts = [p.pin_memory().to(device, non_blocking=True) for p in parts]
    else:
        parts = [p.to(device) for p in parts]
    return decode_u8(*parts, payload["shape"], payload["bits"], payload["axis"])
