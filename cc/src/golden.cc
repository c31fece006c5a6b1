// Native golden rasterizer: wire-format scene -> RGBA8 image.
//
// Scalar C++ implementation of the reference's two GPU kernels --
// tileKernel (PietRender.metal:160-454) and renderKernel (:457-566) --
// byte-compatible with the Python oracle in piet_tpu/raster/ (identical f32
// expressions; compiled with -ffp-contract=off so multiply/add rounding
// matches numpy).  Used as a fast independent oracle for large images and
// as the native-component parity deliverable (SURVEY.md section 7,
// translation decision 3).
//
// Covers the full piet-tpu item set: the reference's four items plus the
// extension items (rect clips, arbitrary-path clip groups, opacity layers,
// 2-stop gradient brushes, combined multi-subpath fills, even-odd fill
// rule) with the exact command semantics of raster/cpu_tiler.py and
// raster/cpu_fine.py.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

#include "piet_cc.h"
#include "../gen/piet_scene_gen.h"
#include "../gen/piet_ptcl_gen.h"
#include "../gen/piet_srgb_gen.h"

namespace {

using std::uint32_t;

float saturate(float v) { return std::min(std::max(v, 0.0f), 1.0f); }

float fsign(float v) { return v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : 0.0f); }

// Deterministic shared division (ops/cmd_math.py::div_det mirror): the
// exact-residual candidate selection is seed-independent, so seeding with
// the IEEE quotient (C++ float division) returns the same bits as the
// device's rcp-seeded selection and numpy's div_det_np.  Candidate order
// and tie handling (prefer the even mantissa) mirror the Python loop.
float div_det(float a, float b) {
  const float q0 = a / b;
  if (b == 0.0f || !std::isfinite(q0)) return q0;
  const float cb = b * 4097.0f;
  const float bh = cb - (cb - b);
  const float bl = b - bh;
  uint32_t u0;
  std::memcpy(&u0, &q0, 4);
  float best_q = q0;
  float best_r = std::numeric_limits<float>::infinity();
  bool best_even = false;
  for (int delta = -3; delta <= 3; ++delta) {
    const uint32_t uq = u0 + static_cast<uint32_t>(delta);
    float q;
    std::memcpy(&q, &uq, 4);
    const float cq = q * 4097.0f;
    const float qh = cq - (cq - q);
    const float ql = q - qh;
    const float r =
        std::fabs((((a - qh * bh) - qh * bl) - ql * bh) - ql * bl);
    const bool even = (uq & 1u) == 0;
    if (r < best_r || (r == best_r && even && !best_even)) {
      best_q = q;
      best_r = r;
      best_even = even;
    }
  }
  return best_q;
}

// sRGB decode/encode use the generated deterministic definitions
// (cc/gen/piet_srgb_gen.h; see piet_tpu/scene/color.py for rationale).
float srgb_encode(float v) { return piet_srgb::encode(v); }

// Extension PTCL command tags (raster/ptcl.py:52-71; no reference analog).
constexpr int32_t kCmdBeginClip = 10;
constexpr int32_t kCmdEndClip = 11;
constexpr int32_t kCmdBeginLayer = 12;
constexpr int32_t kCmdEndLayer = 13;
constexpr int32_t kCmdDrawLinGrad = 14;
constexpr int32_t kCmdDrawRadGrad = 15;
constexpr int32_t kCmdWind = 16;

// Scene item flag bits (scene/scene.py:47-63).
constexpr uint32_t kFlagEvenOdd = 1;
constexpr uint32_t kFlagInGroup = 2;
constexpr uint32_t kFlagPopLayer = 4;
constexpr uint32_t kFlagBrushLinear = 8;
constexpr uint32_t kFlagBrushRadial = 16;
constexpr uint32_t kFlagFillCont = 32;
constexpr uint32_t kFlagFillFinal = 64;

constexpr int kMaxGroupDepth = 4;  // scene.MAX_GROUP_DEPTH

// "No clip" rect (raster/ptcl.py::NO_CLIP): the coverage multiply is an
// exact *1.0.
constexpr float kNoClip[4] = {-1e9f, -1e9f, 1e9f, 1e9f};

struct LinColor {
  float r, g, b, a;
};

// Logical 0xRRGGBBAA -> linear rgb + alpha (see piet_tpu/scene/color.py).
LinColor decode_color(uint32_t c) {
  return {piet_srgb::decode((c >> 24) & 0xFF),
          piet_srgb::decode((c >> 16) & 0xFF),
          piet_srgb::decode((c >> 8) & 0xFF),
          (c & 0xFF) / 255.0f};
}

uint32_t from_be(uint32_t v) {
  return ((v & 0xFF) << 24) | ((v & 0xFF00) << 8) | ((v >> 8) & 0xFF00) |
         (v >> 24);
}

// ---- PTCL command (dense form; see piet_tpu/raster/ptcl.py) -------------
// Words 8-11 of draw commands carry the item's clip rect (ARG_WORDS = 12).
struct Cmd {
  int32_t tag;
  float a[12];
};

// TileEncoder semantics (PietRender.metal:69-157 + extension commands,
// raster/ptcl.py::TileCmdEncoder).
struct TileEnc {
  std::vector<Cmd> cmds;
  uint32_t solid_color = 0xFFFFFFFF;
  int32_t overflow = 0;
  int32_t capacity;

  explicit TileEnc(int32_t cap) : capacity(cap) {}

  bool push(int32_t tag, std::initializer_list<float> args) {
    if (static_cast<int32_t>(cmds.size()) >= capacity) {
      ++overflow;
      return false;
    }
    Cmd c{tag, {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0}};
    int i = 0;
    for (float v : args) c.a[i++] = v;
    cmds.push_back(c);
    return true;
  }

  void push_clipped(int32_t tag, std::initializer_list<float> args,
                    const float* clip) {
    // The clip rect rides words 8-11 of the SAME command; a push dropped
    // at capacity must not touch the previous command's words.
    if (push(tag, args)) std::memcpy(cmds.back().a + 8, clip, 16);
  }

  void clear_solid() { solid_color = 0; }

  // ycull: the emitting stroke's hw + 0.5 in arg word 4 (unused by the
  // fine math; kept in the wire format -- see ops/cmd_math.py).
  // Word 5: per-command inverse squared length (division-free fine math;
  // raster/ptcl.py::line mirror).
  void line(float x0, float y0, float x1, float y1, float ycull,
            float inv_denom) {
    clear_solid();
    push(piet::Cmd_Line, {x0, y0, x1, y1, ycull, inv_denom});
  }
  void stroke(uint32_t rgba, float width, const float* clip) {
    clear_solid();
    const LinColor c = decode_color(rgba);
    push_clipped(piet::Cmd_Stroke, {0.5f * width, c.r, c.g, c.b, c.a}, clip);
  }
  // Fill operands [sx, sy, ey, m, K]: the per-SEGMENT constants of the
  // division-free trapezoid math (raster/ptcl.py mirror; a clipped
  // sub-segment carries the SEGMENT's slope words).
  void fill(float x0, float y0, float /*x1*/, float y1, float m, float K) {
    push(piet::Cmd_Fill, {x0, y0, y1, m, K});
  }
  void fill_edge(float sign, float y) {
    push(piet::Cmd_FillEdge, {sign, y});
  }
  void wind(int backdrop) {
    push(kCmdWind, {static_cast<float>(backdrop)});
  }
  void draw_fill(int backdrop, uint32_t rgba, bool even_odd,
                 const float* clip) {
    clear_solid();
    const LinColor c = decode_color(rgba);
    push_clipped(piet::Cmd_DrawFill, {static_cast<float>(backdrop), c.r, c.g, c.b, c.a,
          even_odd ? 1.0f : 0.0f}, clip);
  }
  void draw_grad(int backdrop, const float* params3, const LinColor& c0,
                 const float* c1, bool radial) {
    clear_solid();
    push(radial ? kCmdDrawRadGrad : kCmdDrawLinGrad,
         {static_cast<float>(backdrop), params3[0], params3[1], params3[2],
          c0.r, c0.g, c0.b, c0.a, c1[0], c1[1], c1[2], c1[3]});
  }
  void circle(const uint16_t* bbox, const float* clip) {
    clear_solid();
    push_clipped(piet::Cmd_Circle, {static_cast<float>(bbox[0]), static_cast<float>(bbox[1]),
          static_cast<float>(bbox[2]), static_cast<float>(bbox[3])}, clip);
  }
  void begin_clip(int backdrop, bool even_odd) {
    clear_solid();
    push(kCmdBeginClip,
         {static_cast<float>(backdrop), even_odd ? 1.0f : 0.0f});
  }
  void end_clip() {
    clear_solid();
    push(kCmdEndClip, {});
  }
  void begin_layer() {
    clear_solid();
    push(kCmdBeginLayer, {});
  }
  void end_layer(float alpha) {
    clear_solid();
    push(kCmdEndLayer, {alpha});
  }
  void solid(uint32_t rgba, const float* clip, bool in_group) {
    if (std::memcmp(clip, kNoClip, 16) != 0 || in_group) {
      // A clipped solid -- or one inside an open clip/layer group -- is a
      // PARTIAL draw: it can neither bail the tile nor leave earlier bail
      // state standing (raster/ptcl.py::TileCmdEncoder.solid).
      solid_color = 0;
    } else if ((rgba & 0xFF) == 0xFF) {  // opaque: cursor reset (:127-142)
      solid_color = rgba;
      cmds.clear();
      overflow = 0;
    }
    const LinColor c = decode_color(rgba);
    push_clipped(piet::Cmd_Solid, {c.r, c.g, c.b, c.a}, clip);
  }
};

struct Seg {
  float sx, sy, ex, ey, a, b, c, xmin, ymin, xmax, ymax;
  // Per-segment constants of the division-free fine math (round 5;
  // ops/cmd_math.py module doc), computed once per segment through the
  // deterministic division selection -- mirrors cpu_tiler.py::_segments.
  float inv_denom, m, K;
};

// Contraction-immune x*x + y*y (ops/cmd_math.py::dot2_det mirror).
float dot2_det(float x, float y) {
  const float cx = x * 4097.0f, hx = cx - (cx - x), lx = x - hx;
  const float cy = y * 4097.0f, hy = cy - (cy - y), ly = y - hy;
  return ((hx * hx + 2.0f * (hx * lx)) + lx * lx) +
         ((hy * hy + 2.0f * (hy * ly)) + ly * ly);
}

std::vector<Seg> make_segs(const float* pts, uint32_t n, bool wrap) {
  std::vector<Seg> out;
  const uint32_t count = wrap ? n : (n > 0 ? n - 1 : 0);
  out.reserve(count);
  for (uint32_t i = 0; i < count; ++i) {
    const uint32_t j = (i + 1 == n) ? 0 : i + 1;
    Seg s;
    s.sx = pts[2 * i];
    s.sy = pts[2 * i + 1];
    s.ex = pts[2 * j];
    s.ey = pts[2 * j + 1];
    s.a = s.ey - s.sy;
    s.b = s.sx - s.ex;
    s.c = -(s.a * s.sx + s.b * s.sy);
    s.xmin = std::min(s.sx, s.ex);
    s.xmax = std::max(s.sx, s.ex);
    s.ymin = std::min(s.sy, s.ey);
    s.ymax = std::max(s.sy, s.ey);
    const float lvx = s.ex - s.sx, lvy = s.ey - s.sy;
    s.inv_denom = div_det(1.0f, dot2_det(lvx, lvy));
    s.m = div_det(lvx, lvy);
    s.K = div_det(-lvy, std::fabs(lvx));
    if (!std::isfinite(s.m)) s.m = 0.0f;
    if (!std::isfinite(s.K)) s.K = 0.0f;
    out.push_back(s);
  }
  return out;
}

// Fill COVERAGE commands (edges + fills) of a closed path for one tile
// (PietRender.metal:248-364; raster/cpu_tiler.py::_fill_coverage).
struct FillCov {
  bool any_fill = false;
  float backdrop = 0.0f;
};

FillCov fill_coverage(TileEnc& enc, const std::vector<Seg>& segs, float x0,
                      float y0, float tw, float th) {
  FillCov fc;
  for (const Seg& s : segs) {
    if (!(s.ymax >= y0 && s.ymin < y0 + th)) continue;
    const float left = s.a * x0;
    const float right = s.a * (x0 + tw);
    const float ytop = std::max(y0, s.ymin);
    const float ybot = std::min(y0 + th, s.ymax);
    const float top = s.b * ytop;
    const float bot = s.b * ybot;
    const float s_top_left = fsign(left + y0 * s.b + s.c);
    const float s00 = fsign(top + left + s.c);
    const float s01 = fsign(top + right + s.c);
    const float s10 = fsign(bot + left + s.c);
    const float s11 = fsign(bot + right + s.c);
    const bool four = s00 * s01 + s00 * s10 + s00 * s11 < 3.0f;
    if (s_top_left == fsign(s.a) && s.ymin <= y0) fc.backdrop -= s00;
    if (s.xmin < x0 && s.xmax > x0) {
      // div_det: the intercept is a PTCL operand; all three oracles and
      // the device compute it through the same selection (cmd_math.py).
      const float t_edge = div_det(s.sx - x0, s.b);
      const float y_edge = s.sy + (s.ey - s.sy) * t_edge;
      if (y_edge >= y0 && y_edge < y0 + th) {
        enc.fill_edge(s00, y_edge);
        if (s.b > 0.0f) {
          enc.fill(s.sx, s.sy, x0, y_edge, s.m, s.K);
        } else {
          enc.fill(x0, y_edge, s.ex, s.ey, s.m, s.K);
        }
        fc.any_fill = true;
      } else if (four) {
        enc.fill(s.sx, s.sy, s.ex, s.ey, s.m, s.K);
        fc.any_fill = true;
      }
    } else if (four && s.xmin < x0 + tw && s.xmax > x0) {
      enc.fill(s.sx, s.sy, s.ex, s.ey, s.m, s.K);
      fc.any_fill = true;
    }
  }
  return fc;
}

// Parsed scene item (wire layouts: scene/wire.py, cc/gen/piet_scene_gen.h).
struct Item {
  uint32_t tag, rgba, flags;
  float width;  // stroke width, or layer/pop alpha
  uint16_t bbox[4];
  float clip[4] = {kNoClip[0], kNoClip[1], kNoClip[2], kNoClip[3]};
  float grad[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  std::vector<Seg> segs;
};

// Fill item for one tile (raster/cpu_tiler.py::_fill_tile): the reference
// fill resolve plus the cont/final (combined multi-subpath), gradient,
// even-odd, rect-clip and in-group extensions.
void fill_tile(TileEnc& enc, const Item& it, float x0, float y0, float tw,
               float th) {
  const FillCov fc = fill_coverage(enc, it.segs, x0, y0, tw, th);
  const bool cont = it.flags & kFlagFillCont;
  const bool final_sub = it.flags & kFlagFillFinal;
  const bool is_grad = it.flags & (kFlagBrushLinear | kFlagBrushRadial);
  if (cont) {
    if (fc.backdrop != 0.0f) enc.wind(static_cast<int>(fc.backdrop));
  } else if (is_grad) {
    if (fc.any_fill || fc.backdrop != 0.0f || final_sub) {
      const LinColor c0 = decode_color(it.rgba);
      enc.draw_grad(static_cast<int>(fc.backdrop), it.grad, c0, it.grad + 3,
                    (it.flags & kFlagBrushRadial) != 0);
    }
  } else if (fc.any_fill || final_sub) {
    enc.draw_fill(static_cast<int>(fc.backdrop), it.rgba,
                  (it.flags & kFlagEvenOdd) != 0, it.clip);
  } else if (fc.backdrop != 0.0f) {
    enc.solid(it.rgba, it.clip, (it.flags & kFlagInGroup) != 0);
  }
}

// Arbitrary-path clip push (raster/cpu_tiler.py::_clip_tile).
void clip_tile(TileEnc& enc, const Item& it, float x0, float y0, float tw,
               float th) {
  const FillCov fc = fill_coverage(enc, it.segs, x0, y0, tw, th);
  enc.begin_clip(static_cast<int>(fc.backdrop),
                 (it.flags & kFlagEvenOdd) != 0);
}

void poly_tile(TileEnc& enc, const Item& it, float x0, float y0, float tw,
               float th) {
  const float hw = 0.5f * it.width + 0.5f;
  bool any = false;
  for (const Seg& s : it.segs) {
    if (!(s.ymax > y0 - hw && s.ymin < y0 + th + hw && s.xmax > x0 - hw &&
          s.xmin < x0 + tw + hw))
      continue;
    const float left = s.a * (x0 - hw);
    const float right = s.a * (x0 + tw + hw);
    const float top = s.b * (y0 - hw);
    const float bot = s.b * (y0 + th + hw);
    const float s00 = fsign(top + left + s.c);
    const float s01 = fsign(top + right + s.c);
    const float s10 = fsign(bot + left + s.c);
    const float s11 = fsign(bot + right + s.c);
    if (s00 * s01 + s00 * s10 + s00 * s11 < 3.0f) {
      enc.line(s.sx, s.sy, s.ex, s.ey, hw, s.inv_denom);
      any = true;
    }
  }
  if (any) enc.stroke(it.rgba, it.width, it.clip);
}

void line_tile(TileEnc& enc, const Item& it, float x0, float y0, float tw,
               float th) {
  const Seg& s = it.segs[0];
  const float hw = 0.5f * it.width + 0.5f;
  const float left = s.a * (x0 - hw);
  const float right = s.a * (x0 + tw + hw);
  const float top = s.b * (y0 - hw);
  const float bot = s.b * (y0 + th + hw);
  const float s00 = fsign(top + left + s.c);
  const float s01 = fsign(top + right + s.c);
  const float s10 = fsign(bot + left + s.c);
  const float s11 = fsign(bot + right + s.c);
  if (s00 * s01 + s00 * s10 + s00 * s11 < 3.0f) {
    enc.line(s.sx, s.sy, s.ex, s.ey, hw, s.inv_denom);
    enc.stroke(it.rgba, it.width, it.clip);
  }
}

// Antialiased coverage of a draw command's clip rect (args words 8-11;
// raster/cpu_fine.py::_clip_cov).  NO_CLIP bounds give exactly 1.0.
float clip_cov(const Cmd& c, float X, float Y) {
  const float covx =
      saturate(std::min(c.a[10], X + 1.0f) - std::max(c.a[8], X));
  const float covy =
      saturate(std::min(c.a[11], Y + 1.0f) - std::max(c.a[9], Y));
  return covx * covy;
}

// Fine interpreter for one pixel (PietRender.metal:457-566 + extension
// commands, raster/cpu_fine.py::render_tile).
void render_pixel(const std::vector<Cmd>& cmds, float X, float Y,
                  float rgb[3]) {
  float df = 1e9f;
  float area = 0.0f;
  rgb[0] = rgb[1] = rgb[2] = 1.0f;
  // Clip / layer group stacks (scene.MAX_GROUP_DEPTH bounds the depth;
  // cov[cov_top] multiplies every draw's alpha, 1.0 when no clip is open).
  float cov[kMaxGroupDepth + 1] = {1.0f};
  int cov_top = 0;
  float layers[kMaxGroupDepth][3];
  int layer_top = 0;
  for (const Cmd& c : cmds) {
    switch (c.tag) {
      case piet::Cmd_Circle: {
        const float cx = c.a[0] + 0.5f * (c.a[2] - c.a[0]);
        const float cy = c.a[1] + 0.5f * (c.a[3] - c.a[1]);
        const float dx = X - cx, dy = Y - cy;
        const float r = std::sqrt(dx * dx + dy * dy);
        const float circle_r = std::min(cx - c.a[0], cy - c.a[1]);
        const float alpha =
            saturate(circle_r - r) * clip_cov(c, X, Y) * cov[cov_top];
        for (int k = 0; k < 3; ++k) rgb[k] = rgb[k] * (1.0f - alpha);
        break;
      }
      case piet::Cmd_Line: {
        // Division-free (round 5): word 5 is the per-command
        // div_det(1, |v|^2); +inf marks a degenerate segment (dot).
        // Mirrors cmd_math.line_field_sq / cpu_fine.py op-for-op.
        const float lvx = c.a[2] - c.a[0], lvy = c.a[3] - c.a[1];
        const float dpx = X - c.a[0], dpy = Y - c.a[1];
        const float inv_denom = c.a[5];
        const float t = std::isfinite(inv_denom)
                            ? saturate((lvx * dpx + lvy * dpy) * inv_denom)
                            : 0.0f;
        const float fx = lvx * t - dpx, fy = lvy * t - dpy;
        df = std::min(df, std::sqrt(fx * fx + fy * fy));
        break;
      }
      case piet::Cmd_Stroke: {
        const float alpha =
            saturate(c.a[0] + 0.5f - df) * clip_cov(c, X, Y) * cov[cov_top];
        const float w = c.a[4] * alpha;
        for (int k = 0; k < 3; ++k) rgb[k] = rgb[k] + (c.a[1 + k] - rgb[k]) * w;
        df = 1e9f;
        break;
      }
      case piet::Cmd_Fill: {
        // Division-free trapezoid coverage (round 5): operands are
        // [sx, sy, ey, m, K] with per-command m = div_det(dx, dy),
        // K = div_det(-dy, |dx|).  Mirrors cmd_math.fill_delta /
        // cpu_fine.py op-for-op; rationale there.
        const float rsy = c.a[1] - Y, rey = c.a[2] - Y;
        const float w0 = saturate(rsy), w1 = saturate(rey);
        if (w0 != w1) {
          const float m = c.a[3], K = c.a[4];
          const float wa = std::min(w0, w1), wb = std::max(w0, w1);
          const float rx = c.a[0] - X;
          const float ua = rx + m * (wa - rsy);
          const float ub = rx + m * (wb - rsy);
          const float umin = std::min(ua, ub);
          const float umax = std::max(ua, ub);
          const auto Fint = [](float u) {
            const float cc = saturate(u);
            return std::min(u, 1.0f) - 0.5f * (cc * cc);
          };
          float delta = (Fint(umax) - Fint(umin)) * K;
          if (!(umax - umin > 1e-4f)) {
            // Wide degenerate-column guard (near-vertical edges), see
            // cpu_fine.py.
            const float u0 = w0 <= w1 ? ua : ub;
            delta = (1.0f - saturate(u0)) * (w0 - w1);
          }
          area += delta;
        }
        break;
      }
      case piet::Cmd_FillEdge: {
        area += c.a[0] * saturate(Y - c.a[1] + 1.0f);
        break;
      }
      case kCmdWind: {
        area += c.a[0];
        break;
      }
      case piet::Cmd_DrawFill: {
        const float x = area + c.a[0];
        // a[5] selects the fill rule: 0 = nonzero winding, 1 = even-odd
        // (piet FillRule::EvenOdd extension; see piet_tpu/scene/scene.py).
        float alpha = c.a[5] != 0.0f
                          ? std::fabs(x - 2.0f * std::nearbyintf(0.5f * x))
                          : std::min(std::fabs(x), 1.0f);
        alpha = alpha * clip_cov(c, X, Y) * cov[cov_top];
        const float w = c.a[4] * alpha;
        for (int k = 0; k < 3; ++k) rgb[k] = rgb[k] + (c.a[1 + k] - rgb[k]) * w;
        area = 0.0f;
        break;
      }
      case piet::Cmd_Solid: {
        const float w = c.a[3] * (clip_cov(c, X, Y) * cov[cov_top]);
        for (int k = 0; k < 3; ++k) rgb[k] = rgb[k] + (c.a[k] - rgb[k]) * w;
        break;
      }
      case kCmdDrawLinGrad:
      case kCmdDrawRadGrad: {
        // Gradient resolve (2-stop brush extension): DrawFill with the
        // color lerped per pixel in LINEAR space (cpu_fine.py:162-183).
        float t;
        if (c.tag == kCmdDrawRadGrad) {
          const float dx = X - c.a[1], dy = Y - c.a[2];
          t = saturate(std::sqrt(dx * dx + dy * dy) * c.a[3]);
        } else {
          t = saturate(c.a[1] * X + c.a[2] * Y + c.a[3]);
        }
        const float fr = c.a[4] + (c.a[8] - c.a[4]) * t;
        const float fg = c.a[5] + (c.a[9] - c.a[5]) * t;
        const float fb = c.a[6] + (c.a[10] - c.a[6]) * t;
        const float fa = c.a[7] + (c.a[11] - c.a[7]) * t;
        const float x = area + c.a[0];
        const float alpha = std::min(std::fabs(x), 1.0f) * cov[cov_top];
        const float w = fa * alpha;
        const float fgp[3] = {fr, fg, fb};
        for (int k = 0; k < 3; ++k) rgb[k] = rgb[k] + (fgp[k] - rgb[k]) * w;
        area = 0.0f;
        break;
      }
      case kCmdBeginClip: {
        const float x = area + c.a[0];
        const float c_alpha =
            c.a[1] != 0.0f
                ? std::fabs(x - 2.0f * std::nearbyintf(0.5f * x))
                : std::min(std::fabs(x), 1.0f);
        if (cov_top < kMaxGroupDepth) {
          cov[cov_top + 1] = cov[cov_top] * c_alpha;
          ++cov_top;
        }
        area = 0.0f;
        break;
      }
      case kCmdEndClip: {
        if (cov_top > 0) --cov_top;
        break;
      }
      case kCmdBeginLayer: {
        if (layer_top < kMaxGroupDepth) {
          std::memcpy(layers[layer_top], rgb, 12);
          ++layer_top;
        }
        break;
      }
      case kCmdEndLayer: {
        float saved[3] = {1.0f, 1.0f, 1.0f};
        if (layer_top > 0) {
          --layer_top;
          std::memcpy(saved, layers[layer_top], 12);
        }
        for (int k = 0; k < 3; ++k)
          rgb[k] = saved[k] + (rgb[k] - saved[k]) * c.a[0];
        break;
      }
      default:
        break;
    }
  }
}

}  // namespace

extern "C" int64_t pm_render_golden(const uint8_t* scene_buf,
                                    int64_t scene_size, int32_t width,
                                    int32_t height, int32_t tile_w,
                                    int32_t tile_h, int32_t cmd_capacity,
                                    uint8_t* out_rgba) {
  const char* buf = reinterpret_cast<const char*>(scene_buf);
  (void)scene_size;
  const uint32_t n_items = piet::load_u32(buf, 0);
  const uint32_t items_ix = piet::load_u32(buf, 4);

  std::vector<Item> items(n_items);
  for (uint32_t i = 0; i < n_items; ++i) {
    Item& it = items[i];
    std::memcpy(it.bbox, buf + 8 + i * 8, 8);
    const uint32_t ref = items_ix + i * piet::PIET_ITEM_SIZE;
    it.tag = piet::PietItem_tag(buf, ref);
    uint32_t clip_ix = 0;
    if (it.tag == piet::PietItem_Circle) {
      it.flags = piet::PietCircle_flags(buf, ref);
      clip_ix = piet::PietCircle_clip_ix(buf, ref);
    } else if (it.tag == piet::PietItem_Line) {
      const auto line = piet::PietStrokeLine_read(buf, ref);
      it.flags = line.flags;
      it.rgba = from_be(line.rgba_color);
      it.width = line.width;
      const float pts[4] = {line.start[0], line.start[1], line.end[0],
                            line.end[1]};
      it.segs = make_segs(pts, 2, false);
    } else if (it.tag == piet::PietItem_LineExt) {
      // A rect-clipped Line: points out-of-line (scene/wire.py).
      const auto line = piet::PietLineExt_read(buf, ref);
      it.tag = piet::PietItem_Line;
      it.flags = line.flags;
      it.rgba = from_be(line.rgba_color);
      it.width = line.width;
      clip_ix = line.clip_ix;
      it.segs = make_segs(
          reinterpret_cast<const float*>(buf + line.points_ix), 2, false);
    } else if (it.tag == piet::PietItem_Fill) {
      const auto fill = piet::PietFill_read(buf, ref);
      it.flags = fill.flags;
      it.rgba = from_be(fill.rgba_color);
      it.width = 0;
      clip_ix = fill.clip_ix;
      if (fill.grad_ix)
        std::memcpy(it.grad, buf + fill.grad_ix, 32);
      it.segs = make_segs(
          reinterpret_cast<const float*>(buf + fill.points_ix),
          fill.n_points, true);
    } else if (it.tag == piet::PietItem_Poly) {
      const auto poly = piet::PietStrokePolyLine_read(buf, ref);
      it.flags = poly.flags;
      it.rgba = from_be(poly.rgba_color);
      it.width = poly.width;
      clip_ix = poly.clip_ix;
      it.segs = make_segs(
          reinterpret_cast<const float*>(buf + poly.points_ix),
          poly.n_points, false);
    } else if (it.tag == piet::PietItem_Clip) {
      const auto cl = piet::PietClip_read(buf, ref);
      it.flags = cl.flags;
      it.segs = make_segs(
          reinterpret_cast<const float*>(buf + cl.points_ix),
          cl.n_points, true);
    } else if (it.tag == piet::PietItem_Pop) {
      const auto pop = piet::PietPop_read(buf, ref);
      it.flags = pop.flags;
      it.width = pop.alpha;
    } else if (it.tag == piet::PietItem_Layer) {
      const auto layer = piet::PietLayer_read(buf, ref);
      it.flags = layer.flags;
      it.width = layer.alpha;
    }
    if (clip_ix) std::memcpy(it.clip, buf + clip_ix, 16);
  }

  const int32_t tiles_x = (width + tile_w - 1) / tile_w;
  const int32_t tiles_y = (height + tile_h - 1) / tile_h;
  const float twf = static_cast<float>(tile_w);
  const float thf = static_cast<float>(tile_h);
  int64_t total_overflow = 0;

  for (int32_t ty = 0; ty < tiles_y; ++ty) {
    for (int32_t tx = 0; tx < tiles_x; ++tx) {
      const float x0 = tx * twf, y0 = ty * thf;
      TileEnc enc(cmd_capacity);
      for (const Item& it : items) {
        const bool hit = it.bbox[2] >= x0 && it.bbox[0] < x0 + twf &&
                         it.bbox[3] >= y0 && it.bbox[1] < y0 + thf;
        if (!hit) continue;
        switch (it.tag) {
          case piet::PietItem_Circle:
            enc.circle(it.bbox, it.clip);
            break;
          case piet::PietItem_Line:
            if (!it.segs.empty()) line_tile(enc, it, x0, y0, twf, thf);
            break;
          case piet::PietItem_Fill:
            fill_tile(enc, it, x0, y0, twf, thf);
            break;
          case piet::PietItem_Poly:
            poly_tile(enc, it, x0, y0, twf, thf);
            break;
          case piet::PietItem_Clip:
            clip_tile(enc, it, x0, y0, twf, thf);
            break;
          case piet::PietItem_Layer:
            enc.begin_layer();
            break;
          case piet::PietItem_Pop:
            if (it.flags & kFlagPopLayer) {
              enc.end_layer(it.width);
            } else {
              enc.end_clip();
            }
            break;
        }
      }
      total_overflow += enc.overflow;
      // Rasterize this tile.
      const int32_t px_w = std::min(tile_w, width - tx * tile_w);
      const int32_t px_h = std::min(tile_h, height - ty * tile_h);
      if (enc.solid_color) {
        const uint32_t s = enc.solid_color;
        const uint8_t col[4] = {
            static_cast<uint8_t>((s >> 24) & 0xFF),
            static_cast<uint8_t>((s >> 16) & 0xFF),
            static_cast<uint8_t>((s >> 8) & 0xFF),
            static_cast<uint8_t>(s & 0xFF)};
        for (int32_t py = 0; py < px_h; ++py) {
          uint8_t* row = out_rgba +
                         ((ty * tile_h + py) * static_cast<int64_t>(width) +
                          tx * tile_w) * 4;
          for (int32_t px = 0; px < px_w; ++px)
            std::memcpy(row + px * 4, col, 4);
        }
      } else {
        for (int32_t py = 0; py < px_h; ++py) {
          uint8_t* row = out_rgba +
                         ((ty * tile_h + py) * static_cast<int64_t>(width) +
                          tx * tile_w) * 4;
          for (int32_t px = 0; px < px_w; ++px) {
            float rgb[3];
            render_pixel(enc.cmds, static_cast<float>(tx * tile_w + px),
                         static_cast<float>(ty * tile_h + py), rgb);
            for (int k = 0; k < 3; ++k) {
              const float s = srgb_encode(std::min(std::max(rgb[k], 0.0f),
                                                   1.0f));
              row[px * 4 + k] = static_cast<uint8_t>(
                  std::lrintf(s * 255.0f));
            }
            row[px * 4 + 3] = 255;
          }
        }
      }
    }
  }
  return total_overflow;
}
