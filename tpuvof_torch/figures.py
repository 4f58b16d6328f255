"""tpuvof's matplotlib figures, drawn with numpy and PIL.

tpuvof writes its figures with matplotlib (tpuvof/io_utils.py). The
machines the port runs on need not have matplotlib, so the port draws the
same figures itself, at the same pixel sizes and in the same colours:

- ``contour_image``: the reference's -s figure, ``plt.contourf(F.T,
  cmap=Blues)`` on a (5, 5 Ly/Lx)-inch figure at 100 dpi, axes off: the
  levels matplotlib's default locator picks (``contour_levels``), each band
  in the colour of its mid level, the field read bilinearly at each pixel
  centre (matplotlib's marching squares draws straight chords inside a
  cell, so a few pixels along band edges differ);
- ``arrow_polygons`` and ``draw_polygons``: ``ax.quiver(..., angles='xy',
  scale_units='xy', scale=1, width=0.002)``'s arrow outlines, filled black
  with 16x16 supersampled coverage (matplotlib's Agg antialiasing);
- ``field_panel``: ``imshow(field.T, origin='lower', vmin, vmax)`` at an
  integer zoom, colours by matplotlib's table lookup, int(x * 256);
- ``labelled_panels``: panels side by side with a title above each.
"""
from __future__ import annotations

import math

import numpy as np

from .colormaps import lut

__all__ = ["contour_levels", "contour_image", "arrow_polygons", "draw_polygons",
           "field_panel", "labelled_panels", "cmap_rgb"]

_WHITE = np.array([255, 255, 255, 255], np.uint8)
SUPERSAMPLE = 16  # arrow coverage is counted on a 16 x 16 grid a pixel
PAD, TITLE_PX = 10, 20  # panels: the margin around and between, a title's row
# matplotlib's default subplot box (figure.subplot.left/right/bottom/top)
_AXES = (0.125, 0.9, 0.11, 0.88)
# the arrow outline of quiver's defaults, in shaft widths
_HEAD_WIDTH, _HEAD_LENGTH, _HEAD_AXIS_LENGTH, _MIN_SHAFT, _MIN_LENGTH = 3.0, 5.0, 4.5, 1.0, 1.0


def cmap_rgb(name: str, x) -> np.ndarray:
    """matplotlib's colour of values ``x`` already normalised to [0, 1]:
    table entry int(x * 256), the top end included in the last entry, out
    of range clipped (its default under/over colours), as floats."""
    table = lut(name)
    idx = np.floor(np.asarray(x, np.float64) * 256.0)
    return table[np.clip(np.nan_to_num(idx, nan=0.0), 0, 255).astype(np.int64)]


def _to_bytes(rgb) -> np.ndarray:
    """Float colours to 8 bits as Agg fills a solid colour: round half up."""
    return np.floor(np.asarray(rgb, np.float64) * 255.0 + 0.5).astype(np.uint8)


def _scale_range(vmin: float, vmax: float, n: int, threshold: float = 100) -> tuple:
    dv = abs(vmax - vmin)
    meanv = (vmax + vmin) / 2
    if abs(meanv) / dv < threshold:
        offset = 0
    else:
        offset = math.copysign(10 ** (math.log10(abs(meanv)) // 1), meanv)
    return 10 ** (math.log10(dv / n) // 1), offset


def _nonsingular(vmin: float, vmax: float, expander: float = 1e-13, tiny: float = 1e-14):
    maxabs = max(abs(vmin), abs(vmax))
    if maxabs < (1e6 / tiny) * np.finfo(float).tiny:
        return -expander, expander
    if vmax - vmin <= maxabs * tiny:
        if vmax == 0 and vmin == 0:
            return -expander, expander
        return vmin - expander * abs(vmin), vmax + expander * abs(vmax)
    return vmin, vmax


def _locator_ticks(vmin: float, vmax: float, nbins: int = 8) -> np.ndarray:
    """``MaxNLocator(nbins, min_n_ticks=1).tick_values(vmin, vmax)`` with
    its default steps and the 'data' autolimit mode."""
    vmin, vmax = _nonsingular(float(vmin), float(vmax))
    steps = np.array([1, 1.5, 2, 2.5, 3, 4, 5, 6, 8, 10])
    steps = np.concatenate([0.1 * steps[:-1], steps, [10 * steps[1]]])
    scale, offset = _scale_range(vmin, vmax, nbins)
    _vmin, _vmax = vmin - offset, vmax - offset
    steps = steps * scale
    large = np.nonzero(steps >= (_vmax - _vmin) / nbins)[0]
    istep = large[0] if len(large) else len(steps) - 1
    for step in steps[:istep + 1][::-1]:
        tol = 1e-10  # _Edge_integer's slop: more where the offset dwarfs the step
        if offset:
            tol = min(0.4999, max(1e-10, 10 ** (math.log10(abs(offset) / step) - 12)))
        best_vmin = (_vmin // step) * step
        d, m = divmod(_vmin - best_vmin, step)
        low = d + 1 if abs(m / step - 1) < tol else d
        d, m = divmod(_vmax - best_vmin, step)
        high = d if abs(m / step) < tol else d + 1
        ticks = np.arange(low, high + 1) * step + best_vmin
        if ((ticks <= _vmax) & (ticks >= _vmin)).sum() >= 1:
            break
    return ticks + offset


def contour_levels(zmin: float, zmax: float) -> np.ndarray:
    """The levels of ``contourf(Z)`` with no levels given: seven asked of
    the locator, the excess beyond the data trimmed."""
    lev = _locator_ticks(zmin, zmax)
    under = np.nonzero(lev < zmin)[0]
    i0 = under[-1] if len(under) else 0
    over = np.nonzero(lev > zmax)[0]
    i1 = over[0] + 1 if len(over) else len(lev)
    if i1 - i0 < 3:
        i0, i1 = 0, len(lev)
    return lev[i0:i1]


def contour_image(F: np.ndarray, Lx: float, Ly: float) -> np.ndarray:
    """(H, W, 4) uint8 RGBA of tpuvof's save_contour_png for field F
    (nx+2, ny+2): filled contours of F.T over x in [0, nx+1], y in [0,
    ny+1] in the default subplot box of a 500 x (500 Ly/Lx) pixel figure."""
    F = np.asarray(F, np.float64)
    W, H = 500, int(Ly / Lx * 5 * 100)
    left, right, bottom, top = _AXES
    x0, x1, y0, y1 = left * W, right * W, bottom * H, top * H
    n0, n1 = F.shape[0] - 1, F.shape[1] - 1  # the data limits
    zmin, zmax = float(F.min()), float(F.max())
    levels = contour_levels(zmin, zmax)
    lowers = levels[:-1].copy()
    if zmin == lowers[0]:
        lowers[0] -= 1  # the minimum belongs to the lowest band
    uppers = levels[1:]
    layers = 0.5 * (levels[:-1] + levels[1:])
    colors = _to_bytes(cmap_rgb("Blues", (layers - levels.min()) / (levels.max() - levels.min())))

    # pixel centres in data coordinates (display y runs up from the bottom row)
    xd = ((np.arange(W) + 0.5) - x0) / (x1 - x0) * n0
    yd = ((H - np.arange(H) - 0.5) - y0) / (y1 - y0) * n1
    inx = (xd > 0) & (xd <= n0)  # matplotlib leaves the column on the left edge white
    iny = (yd >= 0) & (yd <= n1)
    xi = np.clip(np.floor(xd).astype(np.int64), 0, n0 - 1)
    yi = np.clip(np.floor(yd).astype(np.int64), 0, n1 - 1)
    fx = (xd - xi)[None, :]
    fy = (yd - yi)[:, None]
    c00 = F[xi[None, :], yi[:, None]]
    c10 = F[xi[None, :] + 1, yi[:, None]]
    c01 = F[xi[None, :], yi[:, None] + 1]
    c11 = F[xi[None, :] + 1, yi[:, None] + 1]
    z = (c00 * (1 - fx) + c10 * fx) * (1 - fy) + (c01 * (1 - fx) + c11 * fx) * fy

    img = np.broadcast_to(_WHITE, (H, W, 4)).copy()
    inside = iny[:, None] & inx[None, :]
    for lo, hi, col in zip(lowers, uppers, colors):
        band = inside & (z > lo) & (z <= hi)
        img[band, :3] = col
    return img


def arrow_polygons(begin: np.ndarray, incre: np.ndarray, width_px: int,
                   height_px: int) -> np.ndarray:
    """(N, 8, 2) outlines, in pixel coordinates (x right, y down), of
    quiver's arrows from ``begin`` by ``incre`` (both in [0, 1]^2 axes
    coordinates, y up) on axes filling a width_px x height_px image."""
    begin = np.asarray(begin, np.float64).reshape(-1, 2)
    incre = np.asarray(incre, np.float64).reshape(-1, 2)
    shaft = 0.002 * width_px
    d = incre * np.array([width_px, height_px])
    length = np.clip(np.hypot(d[:, 0], d[:, 1]) / shaft, 0, 2 ** 16)[:, None]
    angle = np.arctan2(d[:, 1], d[:, 0])
    # quiver's _h_arrows: the outline along +x in shaft widths
    minsh = _MIN_SHAFT * _HEAD_LENGTH
    x = np.array([0, -_HEAD_AXIS_LENGTH, -_HEAD_LENGTH, 0]) + np.array([0, 1, 1, 1]) * length
    y = np.repeat((0.5 * np.array([1, 1, _HEAD_WIDTH, 0]))[None, :], len(length), axis=0)
    x0 = np.array([0, minsh - _HEAD_AXIS_LENGTH, minsh - _HEAD_LENGTH, minsh])
    ii = [0, 1, 2, 3, 2, 1, 0, 0]
    X, Y = x[:, ii], y[:, ii]
    Y[:, 3:-1] *= -1
    Y0 = (0.5 * np.array([1, 1, _HEAD_WIDTH, 0]))[ii]
    Y0[3:-1] *= -1
    shrink = length / minsh
    short = np.repeat(length < minsh, 8, axis=1)
    np.copyto(X, shrink * x0[ii][None, :], where=short)
    np.copyto(Y, shrink * Y0[None, :], where=short)
    tooshort = np.repeat(length < _MIN_LENGTH, 8, axis=1)
    th = np.arange(8) * (np.pi / 3.0)
    np.copyto(X, np.broadcast_to(np.cos(th) * _MIN_LENGTH * 0.5, X.shape), where=tooshort)
    np.copyto(Y, np.broadcast_to(np.sin(th) * _MIN_LENGTH * 0.5, Y.shape), where=tooshort)
    c, s = np.cos(angle)[:, None], np.sin(angle)[:, None]
    px = (X * c - Y * s) * shaft + begin[:, :1] * width_px
    py = (X * s + Y * c) * shaft + begin[:, 1:] * height_px
    return np.stack([px, height_px - py], axis=-1)


def draw_polygons(img: np.ndarray, polygons: np.ndarray) -> np.ndarray:
    """``img`` (H, W, C) uint8 with ``polygons`` (N, V, 2, pixel
    coordinates) filled black, each pixel darkened by the share of its
    area they cover, counted on a SUPERSAMPLE-fold grid, 32 image rows at
    a time (a whole 1024^2 frame's grid would take 268 MB)."""
    from PIL import Image, ImageDraw

    H, W = img.shape[:2]
    k, band = SUPERSAMPLE, 32
    cover = np.zeros((H, W), np.float64)
    polygons = np.asarray(polygons, np.float64).reshape(-1, polygons.shape[-2], 2) * k
    ylo, yhi = polygons[..., 1].min(axis=1), polygons[..., 1].max(axis=1)
    for r0 in range(0, H, band):
        r1 = min(H, r0 + band)
        mask = Image.new("L", (W * k, (r1 - r0) * k), 0)
        draw = ImageDraw.Draw(mask)
        for poly in polygons[(yhi >= r0 * k) & (ylo <= r1 * k)]:
            draw.polygon([(px, py - r0 * k) for px, py in poly.tolist()], fill=255)
        cover[r0:r1] = np.asarray(mask.resize((W, r1 - r0), Image.BOX), np.float64) / 255.0
    out = img.astype(np.float64)
    out[..., :3] *= (1.0 - cover)[..., None]
    return np.floor(out + 0.5).astype(np.uint8)


def field_panel(field: np.ndarray, cmap: str, vmin: float, vmax: float, zoom: int) -> np.ndarray:
    """(zoom * ny', zoom * nx', 3) uint8: ``imshow(field.T, origin='lower',
    cmap, vmin, vmax)`` with each cell a zoom x zoom block."""
    field = np.asarray(field, np.float64)
    rgb = cmap_rgb(cmap, (field - vmin) / (vmax - vmin))
    img = (rgb.transpose(1, 0, 2)[::-1] * 255.0).astype(np.uint8)
    return img.repeat(zoom, axis=0).repeat(zoom, axis=1)


def labelled_panels(panels, titles) -> np.ndarray:
    """(H, W, 4) uint8 RGBA: ``panels`` side by side on white, PAD pixels
    apart and around, each under its title (PIL's default font; no title
    row where every title is empty)."""
    from PIL import Image, ImageDraw

    pad = PAD
    title_h = TITLE_PX if any(titles) else 0
    h = max(p.shape[0] for p in panels)
    w = sum(p.shape[1] for p in panels) + pad * (len(panels) + 1)
    canvas = Image.new("RGBA", (w, h + title_h + 2 * pad), (255, 255, 255, 255))
    draw = ImageDraw.Draw(canvas)
    x = pad
    for p, title in zip(panels, titles):
        if title:
            draw.text((x + p.shape[1] // 2, pad + title_h // 2), title, fill=(0, 0, 0, 255),
                      anchor="mm")
        canvas.paste(Image.fromarray(p, "RGB"), (x, pad + title_h))
        x += p.shape[1] + pad
    return np.asarray(canvas)
