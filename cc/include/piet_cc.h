// piet-tpu native library: C ABI surface.
//
// Native equivalent of the reference's Rust staticlib + C FFI
// (reference: include/piet_metal.h, src/lib.rs:387-393).  The reference
// exposed exactly one symbol (init_test_scene) writing the demo scene into a
// caller-provided buffer; we keep that entry point for parity and add the
// full encoder / flattener / golden-rasterizer surface the framework needs.
//
// All functions return 0 on success, negative on error.  Buffers are
// caller-allocated; *_size parameters are in/out (in: capacity, out: used).

#pragma once
#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

// -- reference-parity entry point (src/lib.rs:387-393) ---------------------
// Builds the 8x-scaled tiger scene from an SVG document into `scene_buf`
// using the byte-exact wire format.  Returns bytes written, or <0 on error.
int64_t pm_init_scene_from_svg(const char* svg_text, double scale,
                               uint8_t* scene_buf, int64_t buf_size);

// -- flattener (src/flatten.rs equivalent) ---------------------------------
// Flatten `n` cubics (8 doubles each: x0,y0,x1,y1,x2,y2,x3,y3) with the
// kurbo to_quads rule at `accuracy`; writes chord endpoints into `out_pts`
// (2 doubles each) and per-cubic counts into `out_counts`.
// Returns total points written, or <0 if out_cap is too small.
int64_t pm_flatten_cubics(const double* cubics, int64_t n, double accuracy,
                          double* out_pts, int64_t out_cap,
                          int32_t* out_counts);

// -- scene encoder (src/lib.rs:79-254 equivalent) --------------------------
// Opaque encoder handle writing the byte-exact wire format.
typedef struct PmEncoder PmEncoder;
PmEncoder* pm_encoder_new(uint8_t* buf, int64_t buf_size);
void pm_encoder_free(PmEncoder* e);
int32_t pm_encoder_begin_group(PmEncoder* e, int32_t n_items);
int32_t pm_encoder_end_group(PmEncoder* e);
int32_t pm_encoder_circle(PmEncoder* e, double cx, double cy, double r);
int32_t pm_encoder_stroke_line(PmEncoder* e, double x0, double y0, double x1,
                               double y1, float width, uint32_t rgba);
/* flags bit 0 = even-odd fill rule (extension; pass 0 for reference
 * semantics). */
int32_t pm_encoder_fill(PmEncoder* e, const double* pts, int32_t n,
                        uint32_t rgba, uint32_t flags);
int32_t pm_encoder_polyline(PmEncoder* e, const double* pts, int32_t n,
                            uint32_t rgba, float width);
int64_t pm_encoder_size(const PmEncoder* e);

// -- native per-frame fixture builder (cc/src/fixtures.cc) ------------------
// C++ twin of scene/fixtures.py::make_animated_frame emitting SoA scene
// arrays directly (tags/colors/widths int32/uint32/f32 of length n; bboxes
// (n,4) i32; pt_offset/n_pts i32; points (>=13n,2) f32; flags u32; clips
// (n,4) f32).  The seeded random draws (centers (n,2), radii, phases,
// color_hi = rng<<8) are t-independent and passed in.  Returns the total
// point count written.
int64_t pm_animated_frame(double t, int32_t n, const double* centers,
                          const double* radii, const double* phases,
                          const uint32_t* color_hi, int32_t* tags,
                          uint32_t* colors, float* widths, int32_t* bboxes,
                          int32_t* pt_offset, int32_t* n_pts, float* points,
                          uint32_t* flags, float* clips);

// -- golden rasterizer (C10/C9 oracle; see piet_tpu/raster/) ---------------
// Renders a wire-format scene buffer to RGBA8.  tile_w/tile_h parameterize
// the binning geometry (16x16 matches the reference; 32x128 is the
// renderer's default); cmd_capacity is the per-tile PTCL capacity.
// `out_rgba` must hold width*height*4 bytes.  Returns the total number of
// overflowed (dropped) commands across tiles (0 = clean), or <0 on error.
int64_t pm_render_golden(const uint8_t* scene_buf, int64_t scene_size,
                         int32_t width, int32_t height, int32_t tile_w,
                         int32_t tile_h, int32_t cmd_capacity,
                         uint8_t* out_rgba);

// -- version ----------------------------------------------------------------
const char* pm_version(void);

#ifdef __cplusplus
}
#endif
