"""Episode rendering to image files (counterpart of
``etmppo_tpu/utils/render.py``), written with numpy and the standard library
alone: no PIL.

``save_episode_gif`` writes an animated GIF89a that loops forever (a
NETSCAPE2.0 extension), each frame with its own colour table and LZW-coded
pixels, and optionally one PNG per frame. The conversions are the JAX
package's: float frames in [0, 1] become uint8 (clipped, then truncated),
one channel becomes RGB, and each pixel is repeated ``scale`` times along
both axes (nearest upscaling).
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import List, Optional, Tuple

import numpy as np


def _to_rgb(frame: np.ndarray, scale: int) -> np.ndarray:
    """(H, W, C) or (H, W) float [0, 1] or uint8 -> (H*scale, W*scale, 3)
    uint8."""
    frame = np.asarray(frame)
    if frame.dtype != np.uint8:
        frame = (np.clip(frame, 0.0, 1.0) * 255).astype(np.uint8)
    if frame.ndim == 2:
        frame = frame[:, :, None]
    if frame.shape[2] == 1:
        frame = np.repeat(frame, 3, axis=2)
    if scale != 1:
        frame = np.repeat(np.repeat(frame, scale, axis=0), scale, axis=1)
    return np.ascontiguousarray(frame)


def _palette(rgb: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(indices (H, W) uint8, palette (n, 3) uint8). A frame of at most 256
    colours is indexed exactly (its colours in sorted order); a frame with
    more is quantised to the fixed 3-3-2 palette (3 bits of red, 3 of green,
    2 of blue)."""
    packed = (rgb[..., 0].astype(np.uint32) << 16
              | rgb[..., 1].astype(np.uint32) << 8 | rgb[..., 2])
    colours, inverse = np.unique(packed, return_inverse=True)
    if len(colours) <= 256:
        palette = np.stack([colours >> 16, (colours >> 8) & 255,
                            colours & 255], axis=1).astype(np.uint8)
        return inverse.reshape(rgb.shape[:2]).astype(np.uint8), palette
    r, g, b = (rgb[..., i] for i in range(3))
    indices = (r >> 5) << 5 | (g >> 5) << 2 | (b >> 6)
    i = np.arange(256)
    palette = np.stack([((i >> 5) & 7) * 255 // 7, ((i >> 2) & 7) * 255 // 7,
                        (i & 3) * 255 // 3], axis=1).astype(np.uint8)
    return indices.astype(np.uint8), palette


def _lzw(indices: np.ndarray, min_code_size: int) -> bytes:
    """GIF's variable-width LZW code of ``indices`` (each < 2**min_code_size),
    packed least significant bit first: a clear code, the codes, and the
    end-of-information code; the table restarts with a clear code when it
    reaches 4096 entries."""
    clear = 1 << min_code_size
    first_free = clear + 2
    codes, widths = [clear], [min_code_size + 1]
    table = {}
    next_code, width = first_free, min_code_size + 1
    data = indices.ravel().tolist()
    prefix = data[0]
    for k in data[1:]:
        key = prefix << 8 | k
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        codes.append(prefix)
        widths.append(width)
        if next_code < 4096:
            table[key] = next_code
            next_code += 1
            if next_code > 1 << width and width < 12:
                width += 1
        else:
            codes.append(clear)
            widths.append(width)
            table.clear()
            next_code, width = first_free, min_code_size + 1
        prefix = k
    codes += [prefix, clear + 1]
    widths += [width, width]
    codes_a = np.asarray(codes, np.int64)[:, None]
    widths_a = np.asarray(widths, np.int64)[:, None]
    bit = np.arange(12)
    bits = ((codes_a >> bit) & 1).astype(np.uint8)[bit < widths_a]
    return np.packbits(bits, bitorder="little").tobytes()


def _sub_blocks(data: bytes) -> bytes:
    out = bytearray()
    for i in range(0, len(data), 255):
        chunk = data[i:i + 255]
        out.append(len(chunk))
        out += chunk
    out.append(0)
    return bytes(out)


def _gif_frame(rgb: np.ndarray, delay_cs: int) -> bytes:
    """A graphic control extension and an image with its local colour
    table."""
    indices, palette = _palette(rgb)
    size_bits = max(1, int(np.ceil(np.log2(max(len(palette), 2)))))
    table = np.zeros((1 << size_bits, 3), np.uint8)
    table[:len(palette)] = palette
    h, w = indices.shape
    min_code_size = max(2, size_bits)
    return (b"\x21\xf9\x04\x00" + struct.pack("<H", delay_cs) + b"\x00\x00"
            + b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h,
                                    0x80 | (size_bits - 1))
            + table.tobytes() + bytes([min_code_size])
            + _sub_blocks(_lzw(indices, min_code_size)))


def write_gif(path: str, images: List[np.ndarray], duration_ms: int) -> None:
    """Writes RGB uint8 ``images`` (all of one size) as a GIF89a that loops
    forever, each shown ``duration_ms`` (stored in centiseconds, truncated).
    Every frame is written: identical consecutive frames are not merged."""
    h, w = images[0].shape[:2]
    out = [b"GIF89a", struct.pack("<HHBBB", w, h, 0x70, 0, 0),
           b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"]
    out += [_gif_frame(img, int(duration_ms / 10)) for img in images]
    out.append(b"\x3b")
    with open(path, "wb") as f:
        f.write(b"".join(out))


def write_png(path: str, rgb: np.ndarray) -> None:
    """Writes an RGB uint8 image as an 8-bit truecolour PNG."""
    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))
    h, w = rgb.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           rgb.reshape(h, w * 3)], axis=1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes()))
                + chunk(b"IEND", b""))


def save_episode_gif(frames: List[np.ndarray], path: str, scale: int = 4,
                     fps: int = 8, png_dir: Optional[str] = None) -> str:
    """Writes ``frames`` (each (H, W, C), float [0,1] or uint8) as an
    animated GIF at ``path``; optionally also one PNG per frame in
    ``png_dir``. A frame of at most 256 colours (every frame of the image
    envs is one) is written exactly; one with more is quantised to a fixed
    3-3-2 palette. Returns the GIF path."""
    if not frames:
        raise ValueError("no frames to save")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    images = [_to_rgb(f, scale) for f in frames]
    write_gif(path, images, int(1000 / fps))
    if png_dir is not None:
        os.makedirs(png_dir, exist_ok=True)
        for i, img in enumerate(images):
            write_png(os.path.join(png_dir, f"frame_{i:04d}.png"), img)
    return path
