"""Image files to uint8 (H, W, 3) arrays, without PIL where the format allows.

The decoder is chosen by the file's format, never by what is installed:

  * PNG, 8 bits per sample and not interlaced (grey, grey + alpha, RGB, RGBA,
    palette): the port's own reader (`read_png`: the chunks, zlib and the
    five scanline filters in numpy; Average and Paeth rows run byte by byte
    in Python, the others vectorised);
  * `.npy`: a uint8 (H, W), (H, W, 3) or (H, W, 4) array;
  * anything else (JPEG, a 16-bit or interlaced PNG, ...): PIL, imported inside
    `load_image`; without PIL this raises, naming the file.

Colour conversion is PIL's `convert("RGB")`: grey is repeated over the three
channels, alpha is dropped, a palette index becomes its palette colour.
`write_png` writes an 8-bit RGB or grey PNG with unfiltered rows (datasets
made where PIL is absent).
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> samples per pixel
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunks(data: bytes):
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IEND":
            return


def _unfilter_slow(kind: int, raw: bytes, prior: np.ndarray, bpp: int) -> np.ndarray:
    """Average (3) or Paeth (4): each byte depends on its left neighbour."""
    out = bytearray(raw)
    up = prior.tobytes()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = up[i]
        if kind == 3:
            out[i] = (out[i] + ((a + b) >> 1)) & 0xFF
        else:
            c = up[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            out[i] = (out[i] + pred) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def _unfilter(data: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    rows = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        start = y * (stride + 1)
        kind = data[start]
        raw = data[start + 1:start + 1 + stride]
        line = np.frombuffer(raw, np.uint8)
        if kind == 0:
            row = line
        elif kind == 1:
            # x[i] = raw[i] + x[i - bpp]: a running sum per byte lane, mod 256
            row = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:
            row = line + prior
        elif kind in (3, 4):
            row = _unfilter_slow(kind, raw, prior, bpp)
        else:
            raise ValueError(f"PNG scanline filter {kind} is not defined")
        rows[y] = row
        prior = rows[y]
    return rows


def read_png(path: str) -> Optional[np.ndarray]:
    """uint8 (H, W, 3) of an 8-bit, non-interlaced PNG; None for a PNG this
    reader does not take (another bit depth, interlaced). Raises for a file
    that is not a PNG or is damaged."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError(f"{path} is not a PNG file")
    header, palette, idat = None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    width, height, depth, colour, _, _, interlace = header
    if depth != 8 or interlace != 0 or colour not in _CHANNELS:
        return None
    bpp = _CHANNELS[colour]
    data = zlib.decompress(b"".join(idat))
    if len(data) != height * (width * bpp + 1):
        raise ValueError(f"{path}: {len(data)} bytes of scanlines for a {width} x {height} PNG")
    pixels = _unfilter(data, height, width * bpp, bpp)
    pixels = pixels.reshape(height, width, bpp)
    if colour == 3:
        if palette is None:
            raise ValueError(f"{path}: palette PNG without PLTE")
        return palette[pixels[..., 0]]
    if colour in (0, 4):
        return np.repeat(pixels[..., :1], 3, axis=-1)
    return np.ascontiguousarray(pixels[..., :3])


def write_png(path: str, image: np.ndarray, level: int = 1) -> None:
    """Write a uint8 (H, W, 3) or (H, W) array as an 8-bit PNG (rows unfiltered)."""
    image = np.ascontiguousarray(image, np.uint8)
    if image.ndim == 2:
        colour = 0
    elif image.ndim == 3 and image.shape[2] == 3:
        colour = 2
    else:
        raise ValueError(f"write_png takes (H, W) or (H, W, 3) uint8, got {image.shape}")
    h, w = image.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), image.reshape(h, -1)], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE)
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(rows.tobytes(), level)))
        f.write(chunk(b"IEND", b""))


def _rgb(arr: np.ndarray, path: str) -> np.ndarray:
    if arr.dtype != np.uint8 or arr.ndim not in (2, 3) or (arr.ndim == 3 and arr.shape[2] not in (3, 4)):
        raise ValueError(f"{path}: expected a uint8 (H, W[, 3|4]) array, got {arr.dtype} {arr.shape}")
    if arr.ndim == 2:
        return np.repeat(arr[..., None], 3, axis=-1)
    return np.ascontiguousarray(arr[..., :3])


def load_image(path: str) -> np.ndarray:
    """The image at `path` as uint8 (H, W, 3) (see the module docstring for
    which decoder reads which format)."""
    if path.lower().endswith(".npy"):
        return _rgb(np.load(path, allow_pickle=False), path)
    with open(path, "rb") as f:
        is_png = f.read(len(PNG_SIGNATURE)) == PNG_SIGNATURE
    if is_png:
        arr = read_png(path)
        if arr is not None:
            return arr
    try:
        from PIL import Image
    except ImportError as e:
        kind = "this PNG variant" if is_png else "this format"
        raise RuntimeError(
            f"{path}: decoding {kind} needs PIL, which is not installed (the port reads "
            "8-bit non-interlaced PNG and .npy without it)") from e
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))
