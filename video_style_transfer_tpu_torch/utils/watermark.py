"""SDXL invisible watermark in numpy, on the host.

The reference pipeline stamps every decoded image with the
``invisible-watermark`` package's DWT-domain watermark when that package
is installed (diffusers' StableDiffusionXLWatermarker). This module
implements the published scheme itself:

- the 48-bit SDXL message (diffusers' WATERMARK_MESSAGE);
- RGB -> YUV, one-level Haar DWT of the U chroma channel, and per-4x4
  block quantisation-index modulation of the largest-magnitude non-DC
  LL coefficient (the ``dwtDct`` / EmbedMaxDct scheme: bit b moves the
  coefficient to the (k + 0.25 + 0.5*b) * scale lattice point);
- the matching decoder (coefficient residue mod scale, majority vote
  across blocks per bit position).

It round-trips through uint8 images; bitwise identity with the C++/cv2
package's output is not claimed (another YUV rounding). Everything here
is uint8 post-processing outside the device path, where the reference's
post-process sits.
"""
from __future__ import annotations

import numpy as np

# diffusers/pipelines/stable_diffusion_xl/watermark.py WATERMARK_MESSAGE
WATERMARK_MESSAGE = 0b101100111110110010010000011110111011000110011110
WATERMARK_BITS = np.array(
    [int(b) for b in bin(WATERMARK_MESSAGE)[2:]], dtype=np.int64)

_SCALE = 36.0   # imwatermark EmbedMaxDct default for the chroma channels
_BLOCK = 4
_MIN_SIZE = 256  # the package refuses smaller images; diffusers skips them


def _rgb_to_yuv(rgb: np.ndarray) -> np.ndarray:
    """float YUV (studio-range analog matrix, delta=128) from uint8 RGB."""
    rgb = rgb.astype(np.float64)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    u = 0.492 * (b - y) + 128.0
    v = 0.877 * (r - y) + 128.0
    return np.stack([y, u, v], axis=-1)


def _yuv_to_rgb(yuv: np.ndarray) -> np.ndarray:
    y, u, v = yuv[..., 0], yuv[..., 1] - 128.0, yuv[..., 2] - 128.0
    r = y + v / 0.877
    b = y + u / 0.492
    g = (y - 0.299 * r - 0.114 * b) / 0.587
    rgb = np.stack([r, g, b], axis=-1)
    return np.clip(np.round(rgb), 0, 255).astype(np.uint8)


def _haar_dwt2(x: np.ndarray):
    """One-level 2D Haar DWT (orthonormal): LL, (LH, HL, HH).

    x must have even height/width. LL of a constant c block is 2c."""
    a = x[0::2, 0::2]
    b = x[0::2, 1::2]
    c = x[1::2, 0::2]
    d = x[1::2, 1::2]
    ll = (a + b + c + d) / 2.0
    lh = (a - b + c - d) / 2.0   # horizontal detail
    hl = (a + b - c - d) / 2.0   # vertical detail
    hh = (a - b - c + d) / 2.0
    return ll, (lh, hl, hh)


def _haar_idwt2(ll, details):
    lh, hl, hh = details
    a = (ll + lh + hl + hh) / 2.0
    b = (ll - lh + hl - hh) / 2.0
    c = (ll + lh - hl - hh) / 2.0
    d = (ll - lh - hl + hh) / 2.0
    h, w = ll.shape
    out = np.empty((2 * h, 2 * w), ll.dtype)
    out[0::2, 0::2] = a
    out[0::2, 1::2] = b
    out[1::2, 0::2] = c
    out[1::2, 1::2] = d
    return out


def _blockify(ll: np.ndarray):
    """(H, W) LL -> (N, BLOCK*BLOCK) row-major blocks + unblock closure."""
    h, w = ll.shape
    bh, bw = h // _BLOCK, w // _BLOCK
    trimmed = ll[:bh * _BLOCK, :bw * _BLOCK]
    blocks = trimmed.reshape(bh, _BLOCK, bw, _BLOCK).transpose(0, 2, 1, 3)
    flat = blocks.reshape(bh * bw, _BLOCK * _BLOCK).copy()

    def unblock(flat_new):
        blk = flat_new.reshape(bh, bw, _BLOCK, _BLOCK).transpose(0, 2, 1, 3)
        out = ll.copy()
        out[:bh * _BLOCK, :bw * _BLOCK] = blk.reshape(bh * _BLOCK,
                                                      bw * _BLOCK)
        return out

    return flat, unblock


def _carrier_positions(flat: np.ndarray) -> np.ndarray:
    """Index of the largest-|coef| non-DC entry of each block (the DC slot
    flat[:, 0] is never modulated, preserving block brightness)."""
    return np.argmax(np.abs(flat[:, 1:]), axis=1) + 1


def embed_bits(ll: np.ndarray, bits: np.ndarray,
               scale: float = _SCALE) -> np.ndarray:
    """Quantization-index-modulate one coefficient per 4x4 LL block."""
    flat, unblock = _blockify(ll)
    pos = _carrier_positions(flat)
    rows = np.arange(flat.shape[0])
    val = flat[rows, pos]
    bit = bits[rows % len(bits)].astype(np.float64)
    mag = np.abs(val)
    new_mag = (np.floor(mag / scale) + 0.25 + 0.5 * bit) * scale
    flat[rows, pos] = np.where(val >= 0.0, new_mag, -new_mag)
    return unblock(flat)


def decode_bits(ll: np.ndarray, n_bits: int,
                scale: float = _SCALE) -> np.ndarray:
    """Majority-vote the per-block residues back into n_bits bits."""
    flat, _ = _blockify(ll)
    pos = _carrier_positions(flat)
    rows = np.arange(flat.shape[0])
    mag = np.abs(flat[rows, pos])
    score = (np.mod(mag, scale) > 0.5 * scale).astype(np.float64)
    sums = np.bincount(rows % n_bits, weights=score, minlength=n_bits)
    counts = np.bincount(rows % n_bits, minlength=n_bits)
    return (sums / np.maximum(counts, 1) > 0.5).astype(np.int64)


def apply_watermark(images: np.ndarray,
                    bits: np.ndarray = WATERMARK_BITS) -> np.ndarray:
    """Stamp uint8 RGB image(s) (H, W, 3) or (B, H, W, 3).

    Images smaller than 256px on either side pass through untouched
    (diffusers skips them for the same reason: too few carrier blocks)."""
    images = np.asarray(images)
    if images.ndim == 3:
        return apply_watermark(images[None], bits)[0]
    b, h, w, _ = images.shape
    if min(h, w) < _MIN_SIZE:
        return images
    he, we = h // 2 * 2, w // 2 * 2  # DWT needs even dims
    out = images.copy()
    for i in range(b):
        yuv = _rgb_to_yuv(images[i, :he, :we])
        ll, details = _haar_dwt2(yuv[..., 1])  # chroma U only (scale 36)
        yuv[..., 1] = _haar_idwt2(embed_bits(ll, bits), details)
        out[i, :he, :we] = _yuv_to_rgb(yuv)
    return out


def decode_watermark(image: np.ndarray,
                     n_bits: int = len(WATERMARK_BITS)) -> np.ndarray:
    """Recover the embedded bits from one uint8 RGB image."""
    image = np.asarray(image)
    h, w, _ = image.shape
    he, we = h // 2 * 2, w // 2 * 2
    yuv = _rgb_to_yuv(image[:he, :we])
    ll, _ = _haar_dwt2(yuv[..., 1])
    return decode_bits(ll, n_bits)


def has_watermark(image: np.ndarray) -> bool:
    """True if the SDXL message decodes from the image."""
    return bool(np.array_equal(decode_watermark(image), WATERMARK_BITS))
