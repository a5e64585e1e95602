// The fixed-point rasteriser behind core/draw.py: cv2 5.0.0's LINE_8
// drawing (modules/imgproc/src/drawing.cpp: LineIterator, clipLine, Line2,
// FillConvexPoly, Circle, ThickLine, PolyLine) on an interleaved uint8
// image, in place, with XY_SHIFT = 16 fractional bits. One difference from
// OpenCV 4's ThickLine, found against cv2 5.0.0: a line thicker than 1 is
// first clipped, with the integer clipLine, to the image widened by the
// thickness on every side. The node stage draws thousands of segments an
// image, so this runs natively (built with g++ at first use).
//
// It also rasterises TrueType glyph outlines as cv2 5.0.0's putText does
// (modules/imgproc/src/drawing_text.cpp over stb_truetype 1.26, public
// domain): quadratic curves flattened to 0.35 px, edges sorted by their
// top, exact signed-area coverage accumulated a scanline at a time in
// float, |coverage| * 255 + 0.5 truncated to 0-255. cv2 pads the glyph's
// box by max(ceil(w / 10), ceil(h / 10)) + 10 pixels on every side and
// shifts the outline by that pad before rasterising, which changes how
// the edges' float coordinates round; so does this.
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

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

// ---------------------------------------------------------------- glyphs
// cv2's float sums, unfused: -march=native would otherwise let g++ contract
// a * b + c into one rounding where the card's host has FMA
#pragma GCC optimize("fp-contract=off")

struct GPoint {
  float x, y;
};
struct GEdge {
  float x0, y0, x1, y1;
  int invert;
};
struct GActive {
  float fx, fdx, fdy, direction, sy, ey;
  int next;  // index into the active pool, -1 at the end
};

// stbtt__tesselate_curve: a quadratic flattened by halving
void tesselate(std::vector<GPoint>& pts, float x0, float y0, float x1, float y1, float x2,
               float y2, float flat2, int n) {
  const float mx = (x0 + 2 * x1 + x2) / 4, my = (y0 + 2 * y1 + y2) / 4;
  const float dx = (x0 + x2) / 2 - mx, dy = (y0 + y2) / 2 - my;
  if (n > 16) return;
  if (dx * dx + dy * dy > flat2) {
    tesselate(pts, x0, y0, (x0 + x1) / 2.0f, (y0 + y1) / 2.0f, mx, my, flat2, n + 1);
    tesselate(pts, mx, my, (x1 + x2) / 2.0f, (y1 + y2) / 2.0f, x2, y2, flat2, n + 1);
  } else {
    pts.push_back({x2, y2});
  }
}

bool edge_above(const GEdge& a, const GEdge& b) { return a.y0 < b.y0; }

// stbtt__sort_edges: a median-of-three quicksort down to runs of 12, then
// an insertion sort (the order of equal tops decides float sums)
void sort_edges_quick(GEdge* p, int n) {
  while (n > 12) {
    GEdge t;
    const int m = n >> 1;
    const bool c01 = edge_above(p[0], p[m]), c12 = edge_above(p[m], p[n - 1]);
    if (c01 != c12) {
      const bool c = edge_above(p[0], p[n - 1]);
      const int z = (c == c12) ? 0 : n - 1;
      t = p[z];
      p[z] = p[m];
      p[m] = t;
    }
    t = p[0];
    p[0] = p[m];
    p[m] = t;
    int i = 1, j = n - 1;
    for (;;) {
      for (;; ++i)
        if (!edge_above(p[i], p[0])) break;
      for (;; --j)
        if (!edge_above(p[0], p[j])) break;
      if (i >= j) break;
      t = p[i];
      p[i] = p[j];
      p[j] = t;
      ++i;
      --j;
    }
    if (j < n - i) {
      sort_edges_quick(p, j);
      p += i;
      n -= i;
    } else {
      sort_edges_quick(p + i, n - i);
      n = j;
    }
  }
}

void sort_edges(GEdge* p, int n) {
  sort_edges_quick(p, n);
  for (int i = 1; i < n; ++i) {
    const GEdge t = p[i];
    int j = i;
    while (j > 0 && edge_above(t, p[j - 1])) {
      p[j] = p[j - 1];
      --j;
    }
    if (i != j) p[j] = t;
  }
}

// stbtt__handle_clipped_edge: an edge piece that stays within column x
void clipped_edge(float* scanline, int x, const GActive& e, float x0, float y0, float x1,
                  float y1) {
  if (y0 == y1 || y0 > e.ey || y1 < e.sy) return;
  if (y0 < e.sy) {
    x0 += (x1 - x0) * (e.sy - y0) / (y1 - y0);
    y0 = e.sy;
  }
  if (y1 > e.ey) {
    x1 += (x1 - x0) * (e.ey - y1) / (y1 - y0);
    y1 = e.ey;
  }
  if (x0 <= x && x1 <= x)
    scanline[x] += e.direction * (y1 - y0);
  else if (x0 >= x + 1 && x1 >= x + 1)
    ;
  else
    scanline[x] += e.direction * (y1 - y0) * (1 - ((x0 - x) + (x1 - x)) / 2);
}

float trapezoid(float height, float top_width, float bottom_width) {
  return (top_width + bottom_width) / 2.0f * height;
}

// stbtt__fill_active_edges_new: each active edge's exact area in one
// scanline, `fill` (offset by one) taking what lies right of it
void fill_active_edges(float* scanline, float* fill, int len, const std::vector<GActive>& pool,
                       int head, float y_top) {
  const float y_bottom = y_top + 1;
  for (int k = head; k >= 0; k = pool[k].next) {
    const GActive& e = pool[k];
    if (e.fdx == 0) {
      const float x0 = e.fx;
      if (x0 < len) {
        if (x0 >= 0) {
          clipped_edge(scanline, (int)x0, e, x0, y_top, x0, y_bottom);
          clipped_edge(fill - 1, (int)x0 + 1, e, x0, y_top, x0, y_bottom);
        } else {
          clipped_edge(fill - 1, 0, e, x0, y_top, x0, y_bottom);
        }
      }
      continue;
    }
    float x0 = e.fx, dx = e.fdx, xb = x0 + dx, x_top, x_bottom, sy0, sy1, dy = e.fdy;
    if (e.sy > y_top) {
      x_top = x0 + dx * (e.sy - y_top);
      sy0 = e.sy;
    } else {
      x_top = x0;
      sy0 = y_top;
    }
    if (e.ey < y_bottom) {
      x_bottom = x0 + dx * (e.ey - y_top);
      sy1 = e.ey;
    } else {
      x_bottom = xb;
      sy1 = y_bottom;
    }
    if (x_top >= 0 && x_bottom >= 0 && x_top < len && x_bottom < len) {
      if ((int)x_top == (int)x_bottom) {  // one pixel
        const int x = (int)x_top;
        const float height = (sy1 - sy0) * e.direction;
        scanline[x] += trapezoid(height, (x + 1.0f) - x_top, (x + 1.0f) - x_bottom);
        fill[x] += height;
      } else {  // two or more pixels
        if (x_top > x_bottom) {  // flip the scanline vertically
          sy0 = y_bottom - (sy0 - y_top);
          sy1 = y_bottom - (sy1 - y_top);
          std::swap(sy0, sy1);
          std::swap(x_bottom, x_top);
          dx = -dx;
          dy = -dy;
          std::swap(x0, xb);
        }
        const int x1 = (int)x_top, x2 = (int)x_bottom;
        float y_crossing = y_top + dy * (x1 + 1 - x0);
        float y_final = y_top + dy * (x2 - x0);
        if (y_crossing > y_bottom) y_crossing = y_bottom;
        const float sign = e.direction;
        float area = sign * (y_crossing - sy0);
        scanline[x1] += area * (x1 + 1 - x_top) / 2;
        if (y_final > y_bottom) {
          const int denom = x2 - (x1 + 1);
          y_final = y_bottom;
          if (denom != 0) dy = (y_final - y_crossing) / denom;
        }
        const float step = sign * dy * 1;
        for (int x = x1 + 1; x < x2; ++x) {
          scanline[x] += area + step / 2;
          area += step;
        }
        scanline[x2] += area + sign * trapezoid(sy1 - y_final, (x2 + 1.0f) - (float)x2,
                                                (x2 + 1.0f) - x_bottom);
        fill[x2] += sign * (sy1 - sy0);
      }
    } else {  // the edge leaves the box: clip it pixel by pixel
      for (int x = 0; x < len; ++x) {
        const float y0 = y_top, xl = (float)x, xr = (float)(x + 1), x3 = xb, y3 = y_bottom;
        const float yl = (x - x0) / dx + y_top, yr = (x + 1 - x0) / dx + y_top;
        if (x0 < xl && x3 > xr) {
          clipped_edge(scanline, x, e, x0, y0, xl, yl);
          clipped_edge(scanline, x, e, xl, yl, xr, yr);
          clipped_edge(scanline, x, e, xr, yr, x3, y3);
        } else if (x3 < xl && x0 > xr) {
          clipped_edge(scanline, x, e, x0, y0, xr, yr);
          clipped_edge(scanline, x, e, xr, yr, xl, yl);
          clipped_edge(scanline, x, e, xl, yl, x3, y3);
        } else if ((x0 < xl && x3 > xl) || (x3 < xl && x0 > xl)) {
          clipped_edge(scanline, x, e, x0, y0, xl, yl);
          clipped_edge(scanline, x, e, xl, yl, x3, y3);
        } else if ((x0 < xr && x3 > xr) || (x3 < xr && x0 > xr)) {
          clipped_edge(scanline, x, e, x0, y0, xr, yr);
          clipped_edge(scanline, x, e, xr, yr, x3, y3);
        } else {
          clipped_edge(scanline, x, e, x0, y0, x3, y3);
        }
      }
    }
  }
}

// stbtt__rasterize_sorted_edges: the bitmap a scanline at a time; new
// edges go to the front of the active list
void rasterize_edges(uint8_t* out, int w, int h, GEdge* e, int n, int off_x, int off_y) {
  std::vector<GActive> pool;
  std::vector<float> buf(2 * w + 1);
  float *scanline = buf.data(), *fill = scanline + w;
  int head = -1;
  e[n].y0 = (float)(off_y + h) + 1;  // sentinel
  for (int j = 0, y = off_y; j < h; ++j, ++y) {
    const float top = y + 0.0f, bottom = y + 1.0f;
    std::fill(buf.begin(), buf.end(), 0.0f);
    for (int* link = &head; *link >= 0;) {
      if (pool[*link].ey <= top)
        *link = pool[*link].next;
      else
        link = &pool[*link].next;
    }
    for (; e->y0 <= bottom; ++e) {
      if (e->y0 == e->y1) continue;
      GActive z;
      const float dxdy = (e->x1 - e->x0) / (e->y1 - e->y0);
      z.fdx = dxdy;
      z.fdy = dxdy != 0.0f ? (1.0f / dxdy) : 0.0f;
      z.fx = e->x0 + dxdy * (top - e->y0);
      z.fx -= off_x;
      z.direction = e->invert ? 1.0f : -1.0f;
      z.sy = e->y0;
      z.ey = e->y1;
      if (j == 0 && off_y != 0 && z.ey < top) z.ey = top;
      z.next = head;
      pool.push_back(z);
      head = (int)pool.size() - 1;
    }
    if (head >= 0) fill_active_edges(scanline, fill + 1, w, pool, head, top);
    float sum = 0;
    for (int i = 0; i < w; ++i) {
      sum += fill[i];
      const float k = (float)std::fabs(scanline[i] + sum) * 255 + 0.5f;
      out[j * w + i] = (uint8_t)std::min((int)k, 255);
    }
    for (int k = head; k >= 0; k = pool[k].next) pool[k].fx += pool[k].fdx;
  }
}

// The glyph's pixel box at `scale`, as stbtt_GetGlyphBitmapBox rounds its
// header box, and cv2's pad around it: {x0, y0, w, h, pad}
void glyph_box(const int32_t* box, float scale, int32_t* out) {
  const int ix0 = (int)std::floor(box[0] * scale + 0.0f);
  const int iy0 = (int)std::floor(-box[3] * scale + 0.0f);
  const int ix1 = (int)std::ceil(box[2] * scale + 0.0f);
  const int iy1 = (int)std::ceil(-box[1] * scale + 0.0f);
  const int w = ix1 - ix0, h = iy1 - iy0;
  out[0] = ix0;
  out[1] = iy0;
  out[2] = w;
  out[3] = h;
  out[4] = std::max((h + 9) / 10, (w + 9) / 10) + 10;
}

}  // namespace

extern "C" {

// A glyph's coverage at `scale` pixels per font unit: `verts` holds n
// stb_truetype vertices (type 1 move, 2 line, 3 quadratic; x, y, cx, cy in
// font units, y up), `box` the glyph header's (xMin, yMin, xMax, yMax).
// `out` is the padded bitmap, (h + 2 pad) x (w + 2 pad) from cv_glyph_box;
// its pixel (0, 0) lies at (x0 - pad, y0 - pad) from the pen, y down.
void cv_glyph_box(const int32_t* box, float scale, int32_t* out) { glyph_box(box, scale, out); }

void cv_glyph_coverage(const int32_t* verts, int n, const int32_t* box, float scale,
                       uint8_t* out) {
  int32_t b[5];
  glyph_box(box, scale, b);
  const int pad = b[4], w = b[2] + 2 * pad, h = b[3] + 2 * pad;
  const float shift = 0.0f + (float)pad;
  const float flat = 0.35f / scale, flat2 = flat * flat;
  std::vector<GPoint> pts;
  std::vector<int> lengths;
  float x = 0, y = 0;
  int start = 0;
  for (int i = 0; i < n; ++i) {
    const int32_t* v = verts + 5 * i;
    if (v[0] == 1) {
      if (i > 0) lengths.push_back((int)pts.size() - start);
      start = (int)pts.size();
      pts.push_back({(float)v[1], (float)v[2]});
    } else if (v[0] == 2) {
      pts.push_back({(float)v[1], (float)v[2]});
    } else {
      tesselate(pts, x, y, (float)v[3], (float)v[4], (float)v[1], (float)v[2], flat2, 0);
    }
    x = (float)v[1];
    y = (float)v[2];
  }
  if (n > 0) lengths.push_back((int)pts.size() - start);
  std::vector<GEdge> edges(pts.size() + 1);
  int ne = 0, m = 0;
  for (const int len : lengths) {
    const GPoint* p = pts.data() + m;
    m += len;
    for (int k = 0, j = len - 1; k < len; j = k++) {
      if (p[j].y == p[k].y) continue;
      int a = k, c = j;
      GEdge& e = edges[ne++];
      e.invert = 0;
      if (p[j].y > p[k].y) {  // the outline's y points up, the bitmap's down
        e.invert = 1;
        a = j;
        c = k;
      }
      e.x0 = p[a].x * scale + shift;
      e.y0 = (p[a].y * -scale + shift) * 1;
      e.x1 = p[c].x * scale + shift;
      e.y1 = (p[c].y * -scale + shift) * 1;
    }
  }
  sort_edges(edges.data(), ne);
  std::memset(out, 0, (size_t)w * h);
  rasterize_edges(out, w, h, edges.data(), ne, b[0], b[1]);
}

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

// A coverage map (ah x aw) blended into the image with its top-left corner
// at (x0, y0), clipped: dst = (dst * (255 - a) + colour * a + 127) / 255.
void cv_draw_coverage(uint8_t* img, int h, int w, int ch, const uint8_t* cov, int ah, int aw,
                      int x0, int y0, const uint8_t* color) {
  const int ya = std::max(y0, 0), yb = std::min(y0 + ah, h);
  const int xa = std::max(x0, 0), xb = std::min(x0 + aw, w);
  for (int y = ya; y < yb; ++y) {
    const uint8_t* a = cov + (size_t)(y - y0) * aw - x0;
    uint8_t* d = img + ((size_t)y * w) * ch;
    for (int x = xa; x < xb; ++x) {
      const int k = a[x];
      if (!k) continue;
      for (int c = 0; c < ch; ++c)
        d[x * ch + c] = (uint8_t)((d[x * ch + c] * (255 - k) + color[c] * k + 127) / 255);
    }
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
