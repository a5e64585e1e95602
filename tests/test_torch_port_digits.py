"""The enumeration image's digits of the PyTorch port against cv2 5.0.0
on the CPU: core/draw.put_text, rasterising core/rubik_digits.py's
outlines, byte-equal to cv2.putText — a dark halo at thickness + 2 under
the digits at the thickness, "0123456789" on a canvas just large
enough — and get_text_size equal to getTextSize, in every render class
of the enumeration's sizes for images 1 to 16384 rows high and at the
two heights on each side of every class boundary (the classes of 1-4096
rows are those the digit table this replaced held), and one digit at
32768 and 65500 rows. Written by scripts/make_digit_outlines.py, which
runs the same check before it writes the outlines.
"""
import cv2
import numpy as np
import pytest

from circuitvision_tpu_torch.core import draw, rubik_digits

FONT = cv2.FONT_HERSHEY_SIMPLEX
DIGITS = "0123456789"


def _sizes(rows):
    """The enumeration's (font scale, thickness) on an image `rows` high."""
    return max(0.4, rows / 900.0), int(max(1, rows / 600.0))


def _class(rows):
    scale, t = _sizes(rows)
    return rubik_digits.render_class(scale, t), rubik_digits.render_class(scale, t + 2)


def _checked_heights(lo, hi):
    """Every render class's heights in lo..hi: each class's first height
    and the two heights on each side of every class boundary."""
    rows, prev = set(), _class(lo - 1) if lo > 1 else None
    for r in range(lo, hi + 1):
        k = _class(r)
        if k != prev:
            rows.update(x for x in range(r - 2, r + 2) if lo <= x <= hi)
        prev = k
    return sorted(rows)


def _both(rows, text=DIGITS):
    """cv2's and the port's drawing at a height's sizes: a dark halo at
    thickness + 2, then blue digits, on white; and both getTextSizes."""
    scale, t = _sizes(rows)
    (tw, th), base = cv2.getTextSize(text, FONT, scale, t + 2)
    pad = 4 + th // 4
    shape, org = (th + base + 2 * pad, tw + 2 * pad, 3), (pad, pad + th)
    want, got = np.full(shape, 255, np.uint8), np.full(shape, 255, np.uint8)
    assert draw.get_text_size(text, scale, t + 2) == ((tw, th), base), rows
    assert draw.get_text_size(text, scale, t) == cv2.getTextSize(text, FONT, scale, t), rows
    for tt, col in ((t + 2, (40, 90, 10)), (t, (0, 0, 255))):
        cv2.putText(want, text, org, FONT, scale, col, tt, cv2.LINE_AA)
        draw.put_text(got, text, org, scale, col, tt)
    return want, got


# the heights in chunks, so that a failure names its range
CHUNKS = [(1, 1024), (1025, 4096), (4097, 6000), (6001, 9000), (9001, 12000),
          (12001, 16384)]


@pytest.mark.parametrize("lo,hi", CHUNKS, ids=lambda v: str(v))
def test_digits_equal_cv2_in_every_render_class(lo, hi):
    heights = _checked_heights(lo, hi)
    assert heights
    for rows in heights:
        want, got = _both(rows)
        assert want.tobytes() == got.tobytes(), f"{rows} rows: {int((want != got).sum())} bytes"


def test_render_classes_of_the_checked_heights():
    """The checked classes: pixel sizes 11 (scale 0.4) to 492 (16384
    rows), the regular weight (thickness 1) up to 1199 rows, size 36, the
    bold one at every size (the halo, thickness + 2, is always bold)."""
    classes = {c for lo, hi in CHUNKS for r in _checked_heights(lo, hi) for c in _class(r)}
    sizes = {s for s, _b in classes}
    assert min(sizes) == 11 and max(sizes) == 492
    assert (11, False) in classes and (11, True) in classes
    assert {b for s, b in classes if s > 36} == {True}
    assert len(classes) == len({c for r in range(1, 16385) for c in _class(r)})


@pytest.mark.parametrize("rows", [32768, 65500])
def test_one_digit_equals_cv2_at_the_tallest_images(rows):
    for d in "08":
        want, got = _both(rows, d)
        assert want.tobytes() == got.tobytes()
