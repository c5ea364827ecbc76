"""The distance weight map of Ronneberger et al. 2015, Eq. 2, worked out
plainly with SciPy: w(x) = w_c(x) + w0 exp(-(d1(x) + d2(x))^2 / (2
sigma^2)) on background pixels, d1 and d2 the Euclidean distances to the
nearest and second nearest cell. It imports nothing of the program.

As the program is configured: w_c weighs the background n_cell / n_bg and
cells 1 (all ones where either class is absent); cells are the
4-connected components of the labels, at most `max_objects` of them,
taken in raster order of their first pixel; d2 is 0 when there is one
cell, and the border term 0 when there is none.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage


def weight_map(labels: np.ndarray, w0: float, sigma2: float, max_objects: int) -> np.ndarray:
    """[h, w] {0, 1} labels -> [h, w] float64 weights."""
    fg = labels != 0
    n_cell, n_bg = int(fg.sum()), int((~fg).sum())
    wc = np.where(fg, 1.0, n_cell / n_bg) if n_cell and n_bg else np.ones(fg.shape)
    comp, n = ndimage.label(fg)
    k = min(n, max_objects)
    if k == 0:
        return wc
    d = np.sort(np.stack([ndimage.distance_transform_edt(comp != i + 1) for i in range(k)]), 0)
    d1 = d[0]
    d2 = d[1] if k > 1 else np.zeros_like(d1)
    border = w0 * np.exp(-((d1 + d2) ** 2) / (2.0 * sigma2))
    return wc + np.where(fg, 0.0, border)
