"""A small PNG codec on the standard library (zlib, struct) and numpy.

The JAX package reads and writes frames through PIL; the port does not
depend on it. read_gray() decodes 8-bit, non-interlaced grayscale (0),
grayscale + alpha (4), RGB (2) and RGBA (6) files with all five row
filters, and converts to one gray channel as PIL's convert("L") does:
(R*19595 + G*38470 + B*7471 + 0x8000) >> 16, alpha ignored.
write_gray() writes an 8-bit grayscale file with no row filter.
"""

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # color type -> bytes per pixel


def _chunks(data: bytes):
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 12 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError("PNG file ends before IEND")


def _unfilter(filt: np.ndarray, scan: np.ndarray) -> np.ndarray:
    """Undo the row filters: scan (H, W, C) uint8 filtered bytes, filt (H,)
    filter types. Byte (y, x) depends on its left, upper and upper-left
    neighbours only, so each anti-diagonal y + x = d is one vectorized
    step for every filter type."""
    if not filt.any():
        return scan
    if filt.max() > 4:
        raise ValueError(f"PNG: unknown row filter {int(filt.max())}")
    H, W, C = scan.shape
    out = np.zeros((H + 1, W + 1, C), np.int32)  # a zero row and column
    s = scan.astype(np.int32)
    for d in range(H + W - 1):
        y = np.arange(max(0, d - W + 1), min(H - 1, d) + 1)
        x = d - y
        a = out[y + 1, x]
        b = out[y, x + 1]
        c = out[y, x]
        pa = np.abs(b - c)
        pb = np.abs(a - c)
        pc = np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        f = filt[y][:, None]
        pred = np.select([f == 1, f == 2, f == 3, f == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        out[y + 1, x + 1] = (s[y, x] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8)


def read(path: str) -> np.ndarray:
    """The file's pixels as (H, W, C) uint8 (C = 1, 2, 3 or 4)."""
    with open(path, "rb") as f:
        data = f.read()
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    W, H, depth, ctype, _comp, _filt, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(f"{path}: only 8-bit non-interlaced gray, gray + "
                         f"alpha, RGB and RGBA are read (bit depth {depth}, "
                         f"color type {ctype}, interlace {interlace})")
    C = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != H * (1 + W * C):
        raise ValueError(f"{path}: {raw.size} image bytes for {W}x{H}x{C}")
    rows = raw.reshape(H, 1 + W * C)
    return _unfilter(rows[:, 0], rows[:, 1:].reshape(H, W, C))


def to_gray(px: np.ndarray) -> np.ndarray:
    """(H, W, C) uint8 -> (H, W) uint8 as PIL's convert("L")."""
    if px.shape[2] <= 2:  # gray, gray + alpha
        return np.ascontiguousarray(px[..., 0])
    r, g, b = (px[..., i].astype(np.uint32) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(
        np.uint8)


def read_gray(path: str) -> np.ndarray:
    return to_gray(read(path))


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def write_gray(path: str, img: np.ndarray) -> None:
    """Write an (H, W) uint8 image as an 8-bit grayscale PNG."""
    img = np.asarray(img)
    if img.ndim != 2 or img.dtype != np.uint8:
        raise ValueError(f"write_gray takes (H, W) uint8, got {img.shape} "
                         f"{img.dtype}")
    H, W = img.shape
    rows = np.concatenate([np.zeros((H, 1), np.uint8), img], axis=1)
    with open(path, "wb") as f:
        f.write(SIGNATURE
                + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 0, 0, 0,
                                              0))
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + _chunk(b"IEND", b""))
