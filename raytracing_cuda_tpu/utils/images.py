"""Framebuffer image I/O (replaces the CUDA-GL interop display path).

The reference publishes frames through a GL pixel buffer object
(main.cpp:141-165); headless runs read the framebuffer back to the host and
write PNGs or feed a window instead. PNGs are written and read with numpy
and zlib alone, so the render path needs no imaging library.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"


def to_host(image) -> np.ndarray:
    """Device framebuffer → host uint8 (H, W, 3)."""
    return np.asarray(image)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def encode_png(image, level: int = 6) -> bytes:
    """(H, W, 3) uint8 → PNG bytes: 8-bit RGB, every row Up-filtered."""
    img = np.ascontiguousarray(to_host(image))
    if img.ndim != 3 or img.shape[2] != 3 or img.dtype != np.uint8:
        raise ValueError(f"PNG needs (H, W, 3) uint8, got {img.shape} "
                         f"{img.dtype}")
    h, w = img.shape[:2]
    rows = img.reshape(h, w * 3)
    up = rows.copy()
    up[1:] -= rows[:-1]                      # Up filter, uint8 wraparound
    raw = np.concatenate([np.full((h, 1), 2, np.uint8), up], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (_PNG_SIG + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + _chunk(b"IEND", b""))


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes (8-bit RGB or RGBA, not interlaced) → (H, W, 3) uint8."""
    if data[:8] != _PNG_SIG:
        raise ValueError("not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in (2, 6) or interlace:
        raise ValueError(f"unsupported PNG (depth {depth}, color type "
                         f"{ctype}, interlace {interlace})")
    bpp = 3 if ctype == 2 else 4
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, 1 + w * bpp)
    out = np.zeros((h, w * bpp), np.uint8)
    prior = np.zeros(w * bpp, np.uint8)
    for y in range(h):
        ftype, f = raw[y, 0], raw[y, 1:]
        if ftype == 0:
            row = f.copy()
        elif ftype == 1:                      # Sub: running sum along x
            row = np.cumsum(f.reshape(w, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif ftype == 2:                      # Up
            row = f + prior
        elif ftype in (3, 4):                 # Average / Paeth, per byte
            row = _unfilter_serial(ftype, f, prior, bpp)
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = prior = row
    return out.reshape(h, w, bpp)[..., :3]


def _unfilter_serial(ftype, f, prior, bpp):
    row = [0] * len(f)
    fl, pl = f.tolist(), prior.tolist()
    for i, x in enumerate(fl):
        a = row[i - bpp] if i >= bpp else 0
        b = pl[i]
        if ftype == 3:
            row[i] = (x + (a + b) // 2) & 0xFF
            continue
        c = pl[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        row[i] = (x + pred) & 0xFF
    return np.asarray(row, np.uint8)


def save_png(image, path: str, level: int = 6) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(image, level))


def load_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def box_downsample(image, n: int) -> np.ndarray:
    """Average n×n pixel boxes — the SSAA resolve (beyond-reference:
    `render/record --ssaa N` renders at N× and resolves here).

    (H·n, W·n, C) uint8 → (H, W, C) uint8, rounded half-up (mean+0.5
    truncate — a uint8 mean is ≤255 so the cast can't overflow). HOST
    twin of the on-device preview resolve (app.loop._box_downsample,
    jnp, traced inside the preview jit); the two are pinned equal by
    tests/test_window_smoke.py::test_host_and_device_downsample_agree."""
    img = np.asarray(image)
    if n == 1:
        return img
    h, w = img.shape[0] // n, img.shape[1] // n
    acc = img.astype(np.float32).reshape(h, n, w, n, -1).mean(axis=(1, 3))
    return (acc + 0.5).astype(np.uint8)


def rmse(a, b) -> float:
    """Per-pixel RMSE on the 0..1 scale."""
    a = np.asarray(a, np.float64) / 255.0
    b = np.asarray(b, np.float64) / 255.0
    return float(np.sqrt(np.mean((a - b) ** 2)))


# Parity gate between a render and the oracle: quantisation-boundary pixels
# may move by a level where the GPU contracts multiply-adds into FMAs and
# uses its own sqrt, pow and division.
PARITY_RMSE = 2e-3
PARITY_LEVELS = 2             # a pixel is "off" beyond this many levels ...
PARITY_OFF_FRACTION = 0.003   # ... and fewer than this share may be off


def parity(img, ref) -> dict:
    """→ {rmse, off_fraction, ok} of img against ref under the gate."""
    a = np.asarray(img, np.int16)
    b = np.asarray(ref, np.int16)
    if a.shape != b.shape:
        raise ValueError(f"shape {a.shape} vs reference {b.shape}")
    off = float(np.mean(np.abs(a - b).max(axis=-1) > PARITY_LEVELS))
    err = rmse(a, b)
    return {"rmse": err, "off_fraction": off,
            "ok": err < PARITY_RMSE and off < PARITY_OFF_FRACTION}
