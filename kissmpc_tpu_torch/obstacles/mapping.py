"""Occupancy-map -> circle-set extraction (offline tool, host-side numpy).

A port-owned copy of `kissmpc_tpu/obstacles/mapping.py` (the port imports
nothing of the JAX package): the same functions, the same results.  It
rebuilds the reference's map script (`obstacle_handling/static_obstacle.py`,
the OpenCV script that converts `rrc_lab.pgm` into maximal inscribed
circles):

 1. threshold the grayscale map at 127 (`static_obstacle.py:22`),
 2. invert so occupied space becomes foreground (`:31`),
 3. exact Euclidean distance transform (`:34`, cv2.DIST_L2),
 4. greedily take the global max as the largest inscribed circle, erase its
    disk from the transform, repeat until the max radius < min_radius
    (`:37-56`).

No OpenCV: the PGM reader and the exact EDT (Felzenszwalb-Huttenlocher
two-pass lower-envelope algorithm) are numpy here, and the C++ fast path is
the port's `native` library (built with g++ on first use); without g++ the
numpy path runs.
"""

from __future__ import annotations

import numpy as np


def read_pgm(path) -> np.ndarray:
    """Minimal P5 (binary) / P2 (ascii) PGM reader -> uint8/uint16 [H, W]."""
    with open(path, "rb") as f:
        data = f.read()

    # Header: magic, then whitespace-separated tokens with '#' comments.
    def tokens():
        i = 0
        while i < len(data):
            c = data[i : i + 1]
            if c.isspace():
                i += 1
                continue
            if c == b"#":
                while i < len(data) and data[i : i + 1] != b"\n":
                    i += 1
                continue
            j = i
            while j < len(data) and not data[j : j + 1].isspace():
                j += 1
            yield i, data[i:j]
            i = j

    gen = tokens()
    _, magic = next(gen)
    if magic not in (b"P5", b"P2"):
        raise ValueError(f"not a PGM file: magic {magic!r}")
    _, w = next(gen)
    _, h = next(gen)
    pos, maxval = next(gen)
    w, h, maxval = int(w), int(h), int(maxval)
    dtype = np.uint8 if maxval < 256 else np.dtype(">u2")
    if magic == b"P5":
        start = pos + len(str(maxval)) + 1  # single whitespace after maxval
        img = np.frombuffer(data, dtype=dtype, count=w * h, offset=start)
    else:
        vals = data[pos + len(str(maxval)) :].split()
        img = np.array([int(v) for v in vals[: w * h]], dtype=dtype)
    return img.reshape(h, w)


def _edt_1d_sq(f: np.ndarray) -> np.ndarray:
    """Felzenszwalb-Huttenlocher 1-D squared distance transform of a sampled
    function f (lower envelope of parabolas rooted at (i, f[i])).  f must be
    finite (use a large sentinel, not inf, for 'no source here')."""
    n = f.shape[0]
    d = np.empty(n)
    v = np.empty(n, dtype=np.int64)  # parabola roots
    z = np.empty(n + 1)  # envelope breakpoints
    k = 0
    v[0] = 0
    z[0] = -np.inf
    z[1] = np.inf
    for q in range(1, n):
        while True:
            p = v[k]
            s = ((f[q] + q * q) - (f[p] + p * p)) / (2 * q - 2 * p)
            if k > 0 and s <= z[k]:
                k -= 1
            else:
                break
        k += 1
        v[k] = q
        z[k] = s
        z[k + 1] = np.inf
    out_k = 0
    for q in range(n):
        while z[out_k + 1] < q:
            out_k += 1
        p = v[out_k]
        d[q] = (q - p) ** 2 + f[p]
    return d


def distance_transform_edt(foreground: np.ndarray) -> np.ndarray:
    """Exact Euclidean distance from each foreground (True/nonzero) pixel to
    the nearest background pixel.  Matches cv2.distanceTransform(DIST_L2)
    semantics on a binary image.  All-foreground inputs get the large
    sentinel distance everywhere (no background to reach)."""
    fg = np.asarray(foreground) != 0
    h, w = fg.shape
    big = float(h * h + w * w + 1)  # finite sentinel > any real sq. distance
    # pass 1: per-column squared distance to nearest background in the column
    d = np.where(fg, big, 0.0)
    for x in range(w):
        col = d[:, x]
        if col.max() == 0.0:
            continue
        d[:, x] = np.minimum(_edt_1d_sq(col), big)
    # pass 2: per-row lower envelope over the column results
    for y in range(h):
        d[y, :] = np.minimum(_edt_1d_sq(d[y, :]), big)
    return np.sqrt(d)


def pack_circles(
    gray: np.ndarray,
    *,
    threshold: int = 127,
    min_radius: float = 1.0,
    max_circles: int | None = None,
    occupied_is_dark: bool = True,
    use_native: bool = True,
):
    """Greedy maximal-inscribed-circle packing of the occupied region.

    Returns (centers [M, 2] in (x, y) pixel coords, radii [M]).  Mirrors the
    reference loop (`static_obstacle.py:37-56`): global max of the EDT ->
    circle, erase the disk *from the transform*, repeat while max >=
    min_radius.  (Like the reference, erased disks are not re-transformed, so
    circles may overlap slightly — that is the reference's packing, kept for
    parity.)
    """
    gray = np.asarray(gray)
    binary = gray > threshold  # True = light (free) as in `:22`
    occupied = ~binary if occupied_is_dark else binary

    if use_native:
        from .. import native

        d = native.edt(occupied)
        if d is not None:
            packed = native.pack_circles_from_dist(
                d.astype(np.float32),
                float(min_radius),
                int(max_circles) if max_circles is not None else d.size,
            )
            if packed is not None:
                return packed

    dist = distance_transform_edt(occupied)

    h, w = dist.shape
    centers = []
    radii = []
    yy, xx = np.mgrid[0:h, 0:w]
    while True:
        idx = int(np.argmax(dist))
        y, x = divmod(idx, w)
        r = float(dist[y, x])
        if r < min_radius:
            break
        centers.append((float(x), float(y)))
        radii.append(r)
        ri = int(r)
        y0, y1 = max(0, y - ri), min(h, y + ri + 1)
        x0, x1 = max(0, x - ri), min(w, x + ri + 1)
        patch_y = yy[y0:y1, x0:x1]
        patch_x = xx[y0:y1, x0:x1]
        disk = (patch_y - y) ** 2 + (patch_x - x) ** 2 <= ri * ri
        region = dist[y0:y1, x0:x1]
        region[disk] = 0.0
        if max_circles is not None and len(centers) >= max_circles:
            break
    return np.asarray(centers, dtype=np.float64).reshape(-1, 2), np.asarray(
        radii, dtype=np.float64
    )


def circles_to_world(
    centers_px: np.ndarray,
    radii_px: np.ndarray,
    *,
    resolution: float = 0.05,
    origin=(0.0, 0.0),
    map_height_px: int | None = None,
):
    """Pixel-space circles -> world-frame meters.

    ``resolution`` is meters/pixel (ROS map_server convention); if
    ``map_height_px`` is given, the y axis is flipped (image row 0 = top,
    world y grows upward)."""
    centers = np.asarray(centers_px, dtype=np.float64).copy()
    if map_height_px is not None:
        centers[:, 1] = map_height_px - 1 - centers[:, 1]
    centers = centers * resolution + np.asarray(origin, dtype=np.float64)
    return centers, np.asarray(radii_px, dtype=np.float64) * resolution
