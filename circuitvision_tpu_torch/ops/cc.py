"""Connected-component label image of a binary raster.

Counterpart of `label_components` in the JAX package's `ops/cc.py`, as
far as the single-image node stage uses it (the label image it returns
beside the node graph): 8-connected components, each foreground pixel
labelled with the linear index of its component's raster-first pixel,
background carrying the sentinel H·W. Labelling is pointer-chasing work,
so it runs on the host (scipy), as the JAX package's own host stage does.
"""
from __future__ import annotations

import numpy as np
from scipy import ndimage


def label_components(mask: np.ndarray) -> np.ndarray:
    fg = np.asarray(mask).astype(bool)
    h, w = fg.shape
    lab, n = ndimage.label(fg, structure=np.ones((3, 3), np.int32))
    root = np.full(n + 1, h * w, np.int32)
    flat = lab.ravel()
    idx = np.nonzero(flat)[0]
    # scipy numbers components in raster order of their first pixel
    ids, first = np.unique(flat[idx], return_index=True)
    root[ids] = idx[first]
    return root[lab]
