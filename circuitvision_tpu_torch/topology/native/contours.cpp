// First-party outer-contour tracer with OpenCV-equivalent semantics.
//
// Reproduces exactly what the reference pipeline consumes from
// cv2.findContours(RETR_EXTERNAL, CHAIN_APPROX_SIMPLE) + contourArea +
// moments + boundingRect (reference get_contours / get_node_connections,
// src/circuit_analyzer.py:388-459, 1380-1446):
//
//   * only TOP-LEVEL outer borders (components nested inside another
//     component's hole are skipped, like RETR_EXTERNAL's hierarchy cut);
//   * enumeration order = reverse raster discovery order (bottom-most
//     component first — cv2 builds its output list by prepending);
//   * per contour: the CHAIN_APPROX_SIMPLE vertex set (direction-change
//     points of the cyclic border chain — straight-run interiors drop
//     out), polygon area and first moments via Green's theorem over the
//     border polygon (NOT pixel counts: for a ring the polygon area
//     includes the hole, which pixel counting misses entirely), and the
//     chain bounding rect.
//
// The traced chain may start/orient differently from cv2's Suzuki-Abe
// walk; every consumed quantity is invariant to that (vertex SET, |area|,
// moment ratios, rect).
//
// Implementation is run-length based: one word-skipping row scan emits
// foreground and background RUNS; 8-connected components and the
// 4-connected outer background are union-find over runs (O(runs), not
// O(pixels)); border tracing tests the fg raster directly — two distinct
// 8-connected components can never be 8-adjacent, so per-pixel labels
// are unnecessary. The previous per-pixel stack flood fills cost
// ~12 ms/image at 600x800; this runs the same semantics in ~1 ms.
//
// Built by circuitvision_tpu_torch/topology/contours.py at first use.
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Pt {
  int32_t x, y;
};

// Clockwise 8-neighborhood starting East.
static const int DX[8] = {1, 1, 0, -1, -1, -1, 0, 1};
static const int DY[8] = {0, 1, 1, 1, 0, -1, -1, -1};

struct Run {
  int32_t x0, x1;  // inclusive
  int32_t parent;  // union-find parent (index into same run array)
};

static int32_t uf_find(std::vector<Run>& runs, int32_t i) {
  int32_t r = i;
  while (runs[r].parent != r) r = runs[r].parent;
  while (runs[i].parent != r) {
    const int32_t nxt = runs[i].parent;
    runs[i].parent = r;
    i = nxt;
  }
  return r;
}

}  // namespace

extern "C" {

// Returns the number of top-level contours (<= max_contours), or -1 on
// vertex-buffer overflow / contour-count overflow.
//
// Outputs:
//   vert_xy  : int32 pairs, vertices of contour k at
//              [offsets[k], offsets[k+1]) (x, y interleaved)
//   offsets  : int32[max_contours + 1]
//   stats    : double[max_contours * 9] =
//              {area, m00, m10, m01, minx, miny, maxx, maxy, root} per
//              contour (root = raster-first linear pixel index)
//              (area = |polygon area| like cv2.contourArea; m00/m10/m01
//               signed Green's-theorem moments like cv2.moments)
int cv_trace_contours(const uint8_t* fg, int h, int w, int32_t* vert_xy,
                      int32_t vert_cap, int32_t* offsets, double* stats,
                      int32_t max_contours) {
  const int64_t hw = (int64_t)h * w;

  // 1. Row scan -> fg runs and bg runs (both in raster order), with
  //    per-row index ranges. Zero bytes are skipped 8 at a time.
  std::vector<Run> fgr, bgr;
  fgr.reserve(1024);
  bgr.reserve(1024);
  std::vector<int32_t> fg_row(h + 1), bg_row(h + 1);
  // Parallel metadata kept out of Run so union-find stays cache-tight.
  std::vector<int32_t> fg_y;  // row of fg run i
  fg_y.reserve(1024);
  for (int y = 0; y < h; ++y) {
    fg_row[y] = (int32_t)fgr.size();
    bg_row[y] = (int32_t)bgr.size();
    const uint8_t* row = fg + (int64_t)y * w;
    int x = 0;
    while (x < w) {
      if (!row[x]) {
        const int bx0 = x;
        // skip background fast: 8 bytes at a time
        while (x + 8 <= w) {
          uint64_t word;
          std::memcpy(&word, row + x, 8);
          if (word != 0) break;
          x += 8;
        }
        while (x < w && !row[x]) ++x;
        bgr.push_back({(int32_t)bx0, (int32_t)(x - 1), (int32_t)bgr.size()});
      } else {
        const int fx0 = x;
        while (x < w && row[x]) ++x;
        fgr.push_back({(int32_t)fx0, (int32_t)(x - 1), (int32_t)fgr.size()});
        fg_y.push_back(y);
      }
    }
  }
  fg_row[h] = (int32_t)fgr.size();
  bg_row[h] = (int32_t)bgr.size();

  if (fgr.empty()) {
    offsets[0] = 0;
    return 0;
  }

  // 2. 8-connected union over fg runs (adjacent rows overlap with the
  //    [x0-1, x1+1] dilation), two-pointer per row pair. The root keeps
  //    the raster-first run index via union-by-min.
  auto fg_union = [&](int32_t a, int32_t b) {
    int32_t ra = uf_find(fgr, a), rb = uf_find(fgr, b);
    if (ra == rb) return;
    if (ra < rb) std::swap(ra, rb);  // smaller index (earlier run) wins
    fgr[ra].parent = rb;
  };
  for (int y = 1; y < h; ++y) {
    int32_t i = fg_row[y - 1], j = fg_row[y];
    const int32_t iend = fg_row[y], jend = fg_row[y + 1];
    while (i < iend && j < jend) {
      // 8-conn: prev run [px0, px1] touches cur run dilated to
      // [cx0-1, cx1+1]
      if (fgr[i].x1 >= fgr[j].x0 - 1 && fgr[i].x0 <= fgr[j].x1 + 1)
        fg_union(i, j);
      if (fgr[i].x1 < fgr[j].x1) ++i; else ++j;
    }
  }

  // 3. 4-connected union over bg runs; outer = union containing any run
  //    that touches the frame.
  for (int y = 1; y < h; ++y) {
    int32_t i = bg_row[y - 1], j = bg_row[y];
    const int32_t iend = bg_row[y], jend = bg_row[y + 1];
    while (i < iend && j < jend) {
      if (bgr[i].x1 >= bgr[j].x0 && bgr[i].x0 <= bgr[j].x1) {
        int32_t ra = uf_find(bgr, i), rb = uf_find(bgr, j);
        if (ra != rb) {
          if (ra < rb) std::swap(ra, rb);
          bgr[ra].parent = rb;
        }
      }
      if (bgr[i].x1 < bgr[j].x1) ++i; else ++j;
    }
  }
  std::vector<uint8_t> bg_outer(bgr.size(), 0);
  for (size_t i = 0; i < bgr.size(); ++i) {
    // Row of bg run i: recover lazily below via the frame tests that
    // need it; runs on row 0 / h-1 are exactly those indexed in
    // [bg_row[0], bg_row[1]) and [bg_row[h-1], bg_row[h]).
    if (bgr[i].x0 == 0 || bgr[i].x1 == w - 1) bg_outer[uf_find(bgr, (int32_t)i)] = 1;
  }
  for (int32_t i = bg_row[0]; i < bg_row[1]; ++i)
    bg_outer[uf_find(bgr, i)] = 1;
  for (int32_t i = bg_row[h - 1]; i < bg_row[h]; ++i)
    bg_outer[uf_find(bgr, i)] = 1;

  // 4. Top-level fg components: a run touching the frame, or 4-adjacent
  //    to an outer bg run (same-row left/right cells, or overlapping
  //    runs on the rows above/below).
  const int32_t n_fg = (int32_t)fgr.size();
  std::vector<uint8_t> top(n_fg, 0);  // indexed by ROOT run index
  auto mark_top = [&](int32_t run) { top[uf_find(fgr, run)] = 1; };
  auto bg_at = [&](int y, int x) -> int32_t {
    // bg run on row y covering column x, or -1. Binary search.
    int32_t lo = bg_row[y], hi = bg_row[y + 1];
    while (lo < hi) {
      const int32_t mid = (lo + hi) / 2;
      if (bgr[mid].x1 < x) lo = mid + 1;
      else if (bgr[mid].x0 > x) hi = mid;
      else return mid;
    }
    return -1;
  };
  for (int32_t i = 0; i < n_fg; ++i) {
    if (top[uf_find(fgr, i)]) continue;
    const int y = fg_y[i];
    const int32_t x0 = fgr[i].x0, x1 = fgr[i].x1;
    if (y == 0 || y == h - 1 || x0 == 0 || x1 == w - 1) {
      mark_top(i);
      continue;
    }
    // same-row neighbors are bg by construction (runs alternate)
    const int32_t bl = bg_at(y, x0 - 1);
    if (bl >= 0 && bg_outer[uf_find(bgr, bl)]) { mark_top(i); continue; }
    const int32_t br = bg_at(y, x1 + 1);
    if (br >= 0 && bg_outer[uf_find(bgr, br)]) { mark_top(i); continue; }
    bool done = false;
    for (int dy = -1; dy <= 1 && !done; dy += 2) {
      const int yy = y + dy;
      // overlapping bg runs on row yy within [x0, x1]
      int32_t lo = bg_row[yy], hi = bg_row[yy + 1];
      // first run with run.x1 >= x0
      while (lo < hi) {
        const int32_t mid = (lo + hi) / 2;
        if (bgr[mid].x1 < x0) lo = mid + 1; else hi = mid;
      }
      for (int32_t k = lo; k < bg_row[yy + 1] && bgr[k].x0 <= x1; ++k) {
        if (bg_outer[uf_find(bgr, k)]) {
          mark_top(i);
          done = true;
          break;
        }
      }
    }
  }

  // 5. Collect top-level components in raster discovery order (root run
  //    index IS discovery order: roots are union-by-min and runs are
  //    created in raster order), then trace in REVERSE (cv2 output
  //    order). First pixel of a component = start of its root run.
  std::vector<int32_t> roots;
  for (int32_t i = 0; i < n_fg; ++i)
    if (uf_find(fgr, i) == i && top[i]) roots.push_back(i);
  // roots is ascending already (scan order); iterate descending below.

  int32_t n_out = 0;
  int32_t vtop = 0;
  std::vector<Pt> chain;
  auto fg_at = [&](int x, int y) -> bool {
    return x >= 0 && y >= 0 && x < w && y < h && fg[(int64_t)y * w + x];
  };
  for (int32_t ri = (int32_t)roots.size() - 1; ri >= 0; --ri) {
    const int32_t r = roots[ri];
    if (n_out >= max_contours) return -1;
    const int x0 = fgr[r].x0, y0 = fg_y[r];
    const int64_t p0 = (int64_t)y0 * w + x0;
    chain.clear();

    // Moore-neighbor trace (clockwise search from the backtrack
    // direction) on the fg raster: any fg 8-neighbor reached from this
    // component IS this component (distinct 8-connected components are
    // never 8-adjacent). Start pixel is the component's raster-first
    // pixel, so its W and N neighbors are background.
    //
    // Termination: the walk is deterministic in the state
    // (pixel, backtrack). The artificial initial backtrack (W) may never
    // recur, so we stop when the state of the FIRST MOVE's landing pixel
    // recurs — at that point exactly one full border cycle has been
    // appended (ending with the start pixel).
    auto find_dir = [&](int px, int py, int back) -> int {
      for (int d = 1; d <= 8; ++d) {
        const int cand = (back + d) & 7;
        if (fg_at(px + DX[cand], py + DY[cand])) return cand;
      }
      return -1;
    };
    const int dir0 = find_dir(x0, y0, 4);
    if (dir0 < 0) {
      chain.push_back({x0, y0});  // isolated pixel
    } else {
      const int x1 = x0 + DX[dir0], y1 = y0 + DY[dir0];
      const int back1 = (dir0 + 4) & 7;
      int cx = x1, cy = y1, back = back1;
      int64_t guard = 8 * hw + 16;
      while (true) {
        chain.push_back({cx, cy});
        const int dir = find_dir(cx, cy, back);
        cx += DX[dir];
        cy += DY[dir];
        back = (dir + 4) & 7;
        if (cx == x1 && cy == y1 && back == back1) break;
        if (--guard <= 0) break;  // safety net; should be unreachable
      }
    }

    // 6. CHAIN_APPROX_SIMPLE vertex set: cyclic direction-change points.
    const int m = (int)chain.size();
    const int32_t voff = vtop;
    if (m == 1) {
      if (vtop + 1 > vert_cap / 2) return -1;
      vert_xy[2 * vtop] = chain[0].x;
      vert_xy[2 * vtop + 1] = chain[0].y;
      ++vtop;
    } else {
      for (int i = 0; i < m; ++i) {
        const Pt& prev = chain[(i + m - 1) % m];
        const Pt& cur = chain[i];
        const Pt& nxt = chain[(i + 1) % m];
        const int din_x = cur.x - prev.x, din_y = cur.y - prev.y;
        const int dout_x = nxt.x - cur.x, dout_y = nxt.y - cur.y;
        if (din_x != dout_x || din_y != dout_y) {
          if (vtop + 1 > vert_cap / 2) return -1;
          vert_xy[2 * vtop] = cur.x;
          vert_xy[2 * vtop + 1] = cur.y;
          ++vtop;
        }
      }
    }

    // 7. Polygon stats over the FULL chain (identical integrals to the
    //    vertex polygon; collinear points change nothing).
    double a2 = 0.0, m10x6 = 0.0, m01x6 = 0.0;
    double minx = chain[0].x, maxx = chain[0].x;
    double miny = chain[0].y, maxy = chain[0].y;
    for (int i = 0; i < m; ++i) {
      const Pt& p = chain[i];
      const Pt& q = chain[(i + 1) % m];
      const double cross =
          (double)p.x * (double)q.y - (double)q.x * (double)p.y;
      a2 += cross;
      m10x6 += cross * (p.x + q.x);
      m01x6 += cross * (p.y + q.y);
      if (p.x < minx) minx = p.x;
      if (p.x > maxx) maxx = p.x;
      if (p.y < miny) miny = p.y;
      if (p.y > maxy) maxy = p.y;
    }
    double* s = stats + (int64_t)n_out * 9;
    s[0] = (a2 < 0 ? -a2 : a2) / 2.0;  // cv2.contourArea
    s[1] = a2 / 2.0;                   // m00 (signed)
    s[2] = m10x6 / 6.0;                // m10
    s[3] = m01x6 / 6.0;                // m01
    s[4] = minx;
    s[5] = miny;
    s[6] = maxx;
    s[7] = maxy;
    s[8] = (double)p0;
    offsets[n_out] = voff;
    ++n_out;
  }
  offsets[n_out] = vtop;
  return n_out;
}

}  // extern "C"
