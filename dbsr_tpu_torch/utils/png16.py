"""Minimal 8/16-bit PNG codec in numpy and zlib (the port's own copy of
``dbsr_tpu/utils/png16.py``; its files are byte-identical to that writer's,
and files whose rows are all unfiltered skip the per-row decode loop).

SyntheticBurstVal stores RAW bursts and ground truths as 16-bit
multi-channel PNGs. Pillow downcasts 16-bit colour PNGs to 8 bits on read
and cannot write them, so this module implements the subset of the PNG
spec the protocol needs: 8/16-bit greyscale, grey+alpha, RGB and RGBA, no
interlacing, all five scanline filters on decode, filter 0 (None) on
encode.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
# color type -> channel count
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_COLOR_TYPE = {1: 0, 3: 2, 2: 4, 4: 6}


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, arr: np.ndarray) -> None:
    """Write ``[H, W]`` or ``[H, W, C]`` uint8/uint16 as a PNG."""
    if arr.ndim == 2:
        arr = arr[:, :, None]
    H, W, C = arr.shape
    if C not in _COLOR_TYPE:
        raise ValueError(f"unsupported channel count {C}")
    if arr.dtype == np.uint8:
        depth = 8
    elif arr.dtype == np.uint16:
        depth = 16
    else:
        raise ValueError(f"unsupported dtype {arr.dtype}")

    ihdr = struct.pack(">IIBBBBB", W, H, depth, _COLOR_TYPE[C], 0, 0, 0)
    raw = arr
    if depth == 16:
        raw = arr.astype(">u2")
    payload = raw.tobytes()
    bpr = W * C * (depth // 8)
    scanlines = b"".join(
        b"\x00" + payload[y * bpr:(y + 1) * bpr] for y in range(H))
    data = zlib.compress(scanlines, 6)
    with open(path, "wb") as f:
        f.write(_SIG)
        f.write(_chunk(b"IHDR", ihdr))
        f.write(_chunk(b"IDAT", data))
        f.write(_chunk(b"IEND", b""))


def _unfilter(scanlines: np.ndarray, filters: np.ndarray,
              bpp: int) -> np.ndarray:
    """Undo PNG scanline filters. ``scanlines`` is [H, bpr] uint8."""
    H, bpr = scanlines.shape
    out = np.zeros_like(scanlines)
    prev = np.zeros(bpr, np.uint8)
    for y in range(H):
        f = filters[y]
        line = scanlines[y].astype(np.int32)
        if f == 0:
            rec = line
        elif f == 1:  # Sub
            rec = line.copy()
            for x in range(bpp, bpr):
                rec[x] = (rec[x] + rec[x - bpp]) & 0xFF
        elif f == 2:  # Up
            rec = (line + prev) & 0xFF
        elif f == 3:  # Average
            rec = line.copy()
            p = prev.astype(np.int32)
            for x in range(bpr):
                a = rec[x - bpp] if x >= bpp else 0
                rec[x] = (rec[x] + ((a + p[x]) >> 1)) & 0xFF
        elif f == 4:  # Paeth
            rec = line.copy()
            p = prev.astype(np.int32)
            for x in range(bpr):
                a = rec[x - bpp] if x >= bpp else 0
                b = p[x]
                c = p[x - bpp] if x >= bpp else 0
                pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                rec[x] = (rec[x] + pred) & 0xFF
        else:
            raise ValueError(f"bad filter {f}")
        out[y] = rec.astype(np.uint8)
        prev = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    """Read a PNG into ``[H, W, C]`` (uint8 or uint16, native byte order)."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:8] != _SIG:
        raise ValueError(f"{path}: not a PNG")
    pos = 8
    idat = []
    ihdr = None
    while pos < len(buf):
        (length,) = struct.unpack(">I", buf[pos:pos + 4])
        tag = buf[pos + 4:pos + 8]
        data = buf[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", data)
        elif tag == b"IDAT":
            idat.append(data)
        elif tag == b"IEND":
            break
    if ihdr is None:
        raise ValueError(f"{path}: missing IHDR")
    W, H, depth, ctype, comp, filt, interlace = ihdr
    if interlace:
        raise ValueError("interlaced PNG not supported")
    if ctype not in _CHANNELS:
        raise ValueError(f"unsupported color type {ctype} (palette?)")
    C = _CHANNELS[ctype]
    bpp = max(1, C * depth // 8)
    bpr = (W * C * depth + 7) // 8

    raw = zlib.decompress(b"".join(idat))
    rows = np.frombuffer(raw, np.uint8).reshape(H, bpr + 1)
    filters = rows[:, 0]
    recon = np.ascontiguousarray(rows[:, 1:])
    if filters.any():  # else every row is unfiltered, as this writer's
        recon = _unfilter(recon, filters, bpp)
    if depth == 16:
        arr = recon.reshape(H, bpr).view(">u2").astype(np.uint16)
        arr = arr.reshape(H, W, C)
    elif depth == 8:
        arr = recon.reshape(H, W, C).copy()
    else:
        raise ValueError(f"unsupported bit depth {depth}")
    return arr
