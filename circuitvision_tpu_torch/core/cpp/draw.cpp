// The fixed-point rasteriser behind core/draw.py: cv2 5.0.0's LINE_8
// drawing (modules/imgproc/src/drawing.cpp: LineIterator, clipLine, Line2,
// FillConvexPoly, Circle, ThickLine, PolyLine) on an interleaved uint8
// image, in place, with XY_SHIFT = 16 fractional bits. One difference from
// OpenCV 4's ThickLine, found against cv2 5.0.0: a line thicker than 1 is
// first clipped, with the integer clipLine, to the image widened by the
// thickness on every side. The node stage draws thousands of segments an
// image, so this runs natively (built with g++ at first use).
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

const int XY_SHIFT = 16;
const int64_t XY_ONE = int64_t(1) << XY_SHIFT;

struct Image {
  uint8_t* data;
  int h, w, ch;
  const uint8_t* color;
  void put(int64_t x, int64_t y) const {
    if (x >= 0 && x < w && y >= 0 && y < h) std::memcpy(data + (y * w + x) * ch, color, ch);
  }
  void hline(int64_t y, int64_t x1, int64_t x2) const {
    for (int64_t x = x1; x <= x2; ++x) std::memcpy(data + (y * w + x) * ch, color, ch);
  }
};

// cv::clipLine on a width x height area; false where the segment misses it
bool clip_line(int64_t width, int64_t height, int64_t& x1, int64_t& y1, int64_t& x2,
               int64_t& y2) {
  if (width <= 0 || height <= 0) return false;
  const int64_t right = width - 1, bottom = height - 1;
  int c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8;
  int c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8;
  if ((c1 & c2) == 0 && (c1 | c2) != 0) {
    int64_t a;
    if (c1 & 12) {
      a = c1 < 8 ? 0 : bottom;
      x1 += (int64_t)((double)(a - y1) * (x2 - x1) / (y2 - y1));
      y1 = a;
      c1 = (x1 < 0) + (x1 > right) * 2;
    }
    if (c2 & 12) {
      a = c2 < 8 ? 0 : bottom;
      x2 += (int64_t)((double)(a - y2) * (x2 - x1) / (y2 - y1));
      y2 = a;
      c2 = (x2 < 0) + (x2 > right) * 2;
    }
    if ((c1 & c2) == 0 && (c1 | c2) != 0) {
      if (c1) {
        a = c1 == 1 ? 0 : right;
        y1 += (int64_t)((double)(a - x1) * (y2 - y1) / (x2 - x1));
        x1 = a;
        c1 = 0;
      }
      if (c2) {
        a = c2 == 1 ? 0 : right;
        y2 += (int64_t)((double)(a - x2) * (y2 - y1) / (x2 - x1));
        x2 = a;
        c2 = 0;
      }
    }
  }
  return (c1 | c2) == 0;
}

// Line: LineIterator, 8-connected, left to right
void line8(const Image& im, int64_t x1, int64_t y1, int64_t x2, int64_t y2) {
  if (!(x1 >= 0 && x1 < im.w && x2 >= 0 && x2 < im.w && y1 >= 0 && y1 < im.h && y2 >= 0 &&
        y2 < im.h) &&
      !clip_line(im.w, im.h, x1, y1, x2, y2))
    return;
  int64_t dx = x2 - x1, dy = y2 - y1, sx = 1, sy = 1;
  if (dx < 0) {
    dx = -dx;
    dy = -dy;
    std::swap(x1, x2);
    std::swap(y1, y2);
  }
  if (dy < 0) {
    dy = -dy;
    sy = -1;
  }
  const bool vert = dy > dx;
  if (vert) std::swap(dx, dy);
  int64_t err = dx - (dy + dy);
  const int64_t plus = dx + dx, minus = -(dy + dy);
  int64_t x = x1, y = y1;
  for (int64_t i = 0; i <= dx; ++i) {
    im.put(x, y);
    const bool step = err < 0;
    err += minus + (step ? plus : 0);
    if (vert) {
      y += sy;
      x += step ? sx : 0;
    } else {
      x += sx;
      y += step ? sy : 0;
    }
  }
}

// Line2: fixed-point end points
void line2(const Image& im, int64_t x1, int64_t y1, int64_t x2, int64_t y2) {
  if (!clip_line(im.w * XY_ONE, im.h * XY_ONE, x1, y1, x2, y2)) return;
  int64_t dx = x2 - x1, dy = y2 - y1;
  const int64_t ax = dx < 0 ? -dx : dx, ay = dy < 0 ? -dy : dy;
  int64_t x_step, y_step, ecount;
  if (ax > ay) {
    if (dx < 0) {
      dy = -dy;
      std::swap(x1, x2);
      std::swap(y1, y2);
    }
    x_step = XY_ONE;
    y_step = (dy * XY_ONE) / (ax | 1);
    ecount = (x2 - x1) >> XY_SHIFT;
  } else {
    if (dy < 0) {
      dx = -dx;
      std::swap(x1, x2);
      std::swap(y1, y2);
    }
    x_step = (dx * XY_ONE) / (ay | 1);
    y_step = XY_ONE;
    ecount = (y2 - y1) >> XY_SHIFT;
  }
  x1 += XY_ONE >> 1;
  y1 += XY_ONE >> 1;
  im.put((x2 + (XY_ONE >> 1)) >> XY_SHIFT, (y2 + (XY_ONE >> 1)) >> XY_SHIFT);
  if (ax > ay) {
    x1 >>= XY_SHIFT;
    for (; ecount >= 0; --ecount, ++x1, y1 += y_step) im.put(x1, y1 >> XY_SHIFT);
  } else {
    y1 >>= XY_SHIFT;
    for (; ecount >= 0; --ecount, x1 += x_step, ++y1) im.put(x1 >> XY_SHIFT, y1);
  }
}

// FillConvexPoly at LINE_8; v holds npts (x, y) pairs at `shift` bits
void fill_convex_poly(const Image& im, const int64_t* v, int npts, int shift) {
  const int64_t delta = (int64_t(1) << shift) >> 1;
  const int64_t delta1 = XY_ONE >> 1, delta2 = XY_ONE >> 1;
  const int64_t up = int64_t(1) << (XY_SHIFT - shift);  // to XY_SHIFT bits
  int64_t p0x = v[2 * (npts - 1)] * up, p0y = v[2 * (npts - 1) + 1] * up;
  int64_t xmin = v[0], xmax = v[0], ymin = v[1], ymax = v[1];
  int imin = 0;
  for (int i = 0; i < npts; ++i) {
    const int64_t px = v[2 * i], py = v[2 * i + 1];
    if (py < ymin) {
      ymin = py;
      imin = i;
    }
    ymax = std::max(ymax, py);
    xmax = std::max(xmax, px);
    xmin = std::min(xmin, px);
    const int64_t qx = px * up, qy = py * up;
    if (shift == 0)
      line8(im, p0x >> XY_SHIFT, p0y >> XY_SHIFT, qx >> XY_SHIFT, qy >> XY_SHIFT);
    else
      line2(im, p0x, p0y, qx, qy);
    p0x = qx;
    p0y = qy;
  }
  xmin = (xmin + delta) >> shift;
  xmax = (xmax + delta) >> shift;
  ymin = (ymin + delta) >> shift;
  ymax = (ymax + delta) >> shift;
  if (npts < 3 || xmax < 0 || ymax < 0 || xmin >= im.w || ymin >= im.h) return;
  ymax = std::min<int64_t>(ymax, im.h - 1);
  int edges = npts;
  int e_idx[2] = {imin, imin}, e_di[2] = {1, npts - 1};
  int64_t e_x[2] = {-XY_ONE, -XY_ONE}, e_dx[2] = {0, 0}, e_ye[2] = {ymin, ymin};
  int64_t y = ymin;
  do {
    for (int i = 0; i < 2; ++i) {
      if (y >= e_ye[i]) {
        int idx0 = e_idx[i], di = e_di[i];
        int idx = idx0 + di;
        if (idx >= npts) idx -= npts;
        for (; edges-- > 0;) {
          const int64_t ty = (v[2 * idx + 1] + delta) >> shift;
          if (ty > y) {
            const int64_t xs = v[2 * idx0] * up;
            const int64_t xe = v[2 * idx] * up;
            e_ye[i] = ty;
            e_dx[i] = ((xe - xs) * 2 + (ty - y)) / (2 * (ty - y));
            e_x[i] = xs;
            e_idx[i] = idx;
            break;
          }
          idx0 = idx;
          idx += di;
          if (idx >= npts) idx -= npts;
        }
      }
    }
    if (edges < 0) break;
    if (y >= 0) {
      const int left = e_x[0] > e_x[1] ? 1 : 0, right = 1 - left;
      int64_t xx1 = (e_x[left] + delta1) >> XY_SHIFT;
      int64_t xx2 = (e_x[right] + delta2) >> XY_SHIFT;
      if (xx2 >= 0 && xx1 < im.w) im.hline(y, std::max<int64_t>(xx1, 0),
                                           std::min<int64_t>(xx2, im.w - 1));
    }
    e_x[0] += e_dx[0];
    e_x[1] += e_dx[1];
  } while (++y <= ymax);
}

// Circle with fill: midpoint steps, horizontal spans
void circle_filled(const Image& im, int64_t cx, int64_t cy, int64_t radius) {
  const int64_t w = im.w, h = im.h;
  int64_t err = 0, dx = radius, dy = 0, plus = 1, minus = (radius << 1) - 1;
  const bool inside = cx >= radius && cx < w - radius && cy >= radius && cy < h - radius;
  while (dx >= dy) {
    const int64_t y11 = cy - dy, y12 = cy + dy, y21 = cy - dx, y22 = cy + dx;
    int64_t x11 = cx - dx, x12 = cx + dx, x21 = cx - dy, x22 = cx + dy;
    if (inside) {
      im.hline(y11, x11, x12);
      im.hline(y12, x11, x12);
      im.hline(y21, x21, x22);
      im.hline(y22, x21, x22);
    } else if (x11 < w && x12 >= 0 && y21 < h && y22 >= 0) {
      x11 = std::max<int64_t>(x11, 0);
      x12 = std::min<int64_t>(x12, w - 1);
      if (y11 >= 0 && y11 < h) im.hline(y11, x11, x12);
      if (y12 >= 0 && y12 < h) im.hline(y12, x11, x12);
      if (x21 < w && x22 >= 0) {
        x21 = std::max<int64_t>(x21, 0);
        x22 = std::min<int64_t>(x22, w - 1);
        if (y21 >= 0 && y21 < h) im.hline(y21, x21, x22);
        if (y22 >= 0 && y22 < h) im.hline(y22, x21, x22);
      }
    }
    ++dy;
    err += plus;
    plus += 2;
    const int64_t mask = err <= 0 ? 0 : -1;
    err -= minus & mask;
    dx += mask;
    minus -= mask & 2;
  }
}

// ThickLine at LINE_8 with integer end points; cv2 5.0.0 clips a line
// thicker than 1 to the image widened by the thickness first
void thick_line(const Image& im, int64_t x0, int64_t y0, int64_t x1, int64_t y1, int thickness,
                int flags) {
  if (thickness > 1) {
    const int64_t t = thickness;
    int64_t a = x0 + t, b = y0 + t, c = x1 + t, d = y1 + t;
    if (!clip_line(im.w + 2 * t, im.h + 2 * t, a, b, c, d)) return;
    x0 = a - t;
    y0 = b - t;
    x1 = c - t;
    y1 = d - t;
  }
  int64_t p0x = x0 * XY_ONE, p0y = y0 * XY_ONE;
  const int64_t p1x = x1 * XY_ONE, p1y = y1 * XY_ONE;
  if (thickness <= 1) {
    line8(im, (p0x + (XY_ONE >> 1)) >> XY_SHIFT, (p0y + (XY_ONE >> 1)) >> XY_SHIFT,
          (p1x + (XY_ONE >> 1)) >> XY_SHIFT, (p1y + (XY_ONE >> 1)) >> XY_SHIFT);
    return;
  }
  const double dx = (p0x - p1x) / (double)XY_ONE, dy = (p1y - p0y) / (double)XY_ONE;
  double r = dx * dx + dy * dy;
  const int odd = thickness & 1;
  const int64_t th = (int64_t)thickness << (XY_SHIFT - 1);
  if (std::fabs(r) > 2.220446049250313e-16) {
    r = (th + odd * XY_ONE * 0.5) / std::sqrt(r);
    const int64_t dpx = (int64_t)std::nearbyint(dy * r), dpy = (int64_t)std::nearbyint(dx * r);
    const int64_t pts[8] = {p0x + dpx, p0y + dpy, p0x - dpx, p0y - dpy,
                            p1x - dpx, p1y - dpy, p1x + dpx, p1y + dpy};
    fill_convex_poly(im, pts, 4, XY_SHIFT);
  }
  for (int i = 0; i < 2; ++i) {
    if (flags & (i + 1))
      circle_filled(im, (p0x + (XY_ONE >> 1)) >> XY_SHIFT, (p0y + (XY_ONE >> 1)) >> XY_SHIFT,
                    (th + (XY_ONE >> 1)) >> XY_SHIFT);
    p0x = p1x;
    p0y = p1y;
  }
}

}  // namespace

extern "C" {

// PolyLine: n integer points (x, y pairs), closed or open, at `thickness`.
void cv_draw_polyline(uint8_t* img, int h, int w, int ch, const int64_t* pts, int n,
                      int closed, const uint8_t* color, int thickness) {
  const Image im{img, h, w, ch, color};
  if (n <= 0) return;
  int flags = closed ? 2 : 3;
  int i = closed ? n - 1 : 0;
  int64_t x0 = pts[2 * i], y0 = pts[2 * i + 1];
  for (i = closed ? 0 : 1; i < n; ++i) {
    thick_line(im, x0, y0, pts[2 * i], pts[2 * i + 1], thickness, flags);
    x0 = pts[2 * i];
    y0 = pts[2 * i + 1];
    flags = 2;
  }
}

// FillConvexPoly of n integer points (shift 0).
void cv_draw_fill_convex(uint8_t* img, int h, int w, int ch, const int64_t* pts, int n,
                         const uint8_t* color) {
  const Image im{img, h, w, ch, color};
  fill_convex_poly(im, pts, n, 0);
}

// Circle, filled.
void cv_draw_circle_filled(uint8_t* img, int h, int w, int ch, int64_t cx, int64_t cy,
                           int64_t radius, const uint8_t* color) {
  const Image im{img, h, w, ch, color};
  circle_filled(im, cx, cy, radius);
}

}  // extern "C"
