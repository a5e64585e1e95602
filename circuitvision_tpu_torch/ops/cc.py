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
    idx = np.flatnonzero(flat)
    ids = flat[idx]
    # scipy numbers components 1, 2, … in raster order of their first
    # pixel, so a component's first pixel is where the running maximum of
    # the labels met so far rises to its label
    rises = np.empty(len(ids), bool)
    rises[:1] = True
    rises[1:] = ids[1:] > np.maximum.accumulate(ids)[:-1]
    root[ids[rises]] = idx[rises]
    return root[lab]
