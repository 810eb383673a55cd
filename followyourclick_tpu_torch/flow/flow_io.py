"""Optical-flow file IO: Middlebury ``.flo`` and ``.pfm`` formats, and
KITTI's 16-bit PNG encoding ((value*64)+2^15, third channel = valid).

A copy of ``followyourclick_tpu/flow/flow_io.py`` (numpy only; the port
imports nothing of the JAX package) with the reader of 16-bit RGB PNGs the
KITTI and HD1K flows need, which PIL narrows to 8 bits.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np

_FLO_MAGIC = 202021.25


def read_flow(path: Union[str, Path]) -> np.ndarray:
    """Read a ``.flo`` file → ``(H, W, 2)`` float32."""
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)
        if magic.size == 0 or magic[0] != _FLO_MAGIC:
            raise IOError(f"{path}: invalid .flo magic {magic}")
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        data = np.fromfile(f, np.float32, count=2 * w * h)
    return data.reshape(h, w, 2)


def write_flow(flow: np.ndarray, path: Union[str, Path]) -> None:
    """Write ``(H, W, 2)`` float32 flow as ``.flo``."""
    flow = np.asarray(flow, dtype=np.float32)
    assert flow.ndim == 3 and flow.shape[2] == 2
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        np.float32(_FLO_MAGIC).tofile(f)
        np.int32(w).tofile(f)
        np.int32(h).tofile(f)
        flow.tofile(f)


def read_pfm(path: Union[str, Path]) -> Tuple[np.ndarray, float]:
    """Read a PFM image → (data, scale). Rows are stored bottom-up and are
    flipped to top-down on return (reference flow_io.py PFM reader)."""
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            color = True
        elif header == b"Pf":
            color = False
        else:
            raise IOError(f"{path}: not a PFM file (header {header!r})")
        dims = f.readline()
        m = re.match(rb"^(\d+)\s(\d+)\s$", dims)
        if not m:
            raise IOError(f"{path}: malformed PFM header")
        w, h = int(m.group(1)), int(m.group(2))
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.fromfile(f, endian + "f")
    shape = (h, w, 3) if color else (h, w)
    return np.flipud(data.reshape(shape)), abs(scale)


def write_pfm(
    data: np.ndarray, path: Union[str, Path], scale: float = 1.0
) -> None:
    data = np.asarray(data, dtype=np.float32)
    color = data.ndim == 3 and data.shape[2] == 3
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{data.shape[1]} {data.shape[0]}\n".encode())
        f.write(f"{-abs(scale)}\n".encode())  # little-endian
        np.flipud(data).astype("<f").tofile(f)


def read_kitti_flow(
    png: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """Decode a KITTI 16-bit flow PNG array ``(H, W, 3)`` (already read BGR or
    RGB with channels [u16*64+2^15, v16*64+2^15, valid]) into
    (flow (H,W,2) float32, valid (H,W) float32)."""
    png = png.astype(np.float32)
    flow = (png[..., :2] - 2**15) / 64.0
    valid = png[..., 2]
    flow[valid < 0.5] = 0.0
    return flow, valid


def flow_to_kitti_png(
    flow: np.ndarray, valid: Optional[np.ndarray] = None
) -> np.ndarray:
    """Encode flow as the KITTI uint16 PNG triplet."""
    h, w = flow.shape[:2]
    out = np.zeros((h, w, 3), dtype=np.uint16)
    out[..., :2] = np.clip(flow * 64.0 + 2**15, 0, 2**16 - 1).astype(np.uint16)
    out[..., 2] = 1 if valid is None else valid.astype(np.uint16)
    return out


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def png_bit_depth(path: Union[str, Path]) -> Optional[int]:
    """The bit depth of a PNG file, or None when ``path`` is no PNG."""
    with open(path, "rb") as f:
        head = f.read(26)
    if head[:8] != _PNG_SIGNATURE:
        return None
    return head[24]


def _unfilter_row(kind: int, row: np.ndarray, prior: np.ndarray,
                  bpp: int) -> np.ndarray:
    """Undo one scanline's PNG filter (uint8 arithmetic wraps mod 256)."""
    if kind == 0:
        return row
    if kind == 1:
        return np.cumsum(row.reshape(-1, bpp), axis=0, dtype=np.uint8
                         ).reshape(-1)
    if kind == 2:
        return row + prior
    out = bytearray(row.tobytes())
    up = prior.tobytes()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = up[i]
        if kind == 3:
            out[i] = (out[i] + ((a + b) >> 1)) & 0xFF
        elif kind == 4:
            c = up[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            out[i] = (out[i] + pred) & 0xFF
        else:
            raise IOError(f"unknown PNG filter type {kind}")
    return np.frombuffer(bytes(out), np.uint8)


def read_png16(path: Union[str, Path]) -> np.ndarray:
    """Read a 16-bit, non-interlaced PNG → uint16 ``(H, W)`` or ``(H, W,
    C)`` in the file's channel order (gray, gray+alpha, RGB or RGBA)."""
    import struct
    import zlib

    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIGNATURE:
        raise IOError(f"{path}: not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    w, h, depth, color, _, _, interlace = header
    if depth != 16 or color not in _PNG_CHANNELS or interlace:
        raise IOError(f"{path}: only 16-bit non-interlaced gray / RGB(A) "
                      f"PNGs are read here (depth {depth}, colour type "
                      f"{color}, interlace {interlace})")
    channels = _PNG_CHANNELS[color]
    bpp = 2 * channels
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, 1 + w * bpp)
    rows = np.empty((h, w * bpp), np.uint8)
    prior = np.zeros(w * bpp, np.uint8)
    for y in range(h):
        prior = rows[y] = _unfilter_row(int(raw[y, 0]), raw[y, 1:], prior,
                                        bpp)
    img = rows.view(">u2").astype(np.uint16).reshape(h, w, channels)
    return img[..., 0] if channels == 1 else img
