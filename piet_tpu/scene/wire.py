"""Byte-exact scene wire format: SoA Scene <-> reference buffer layout.

Serializes a `Scene` to exactly the bytes the reference's Rust ``Encoder``
produces (reference: src/lib.rs:103-240, layout constants GenTypes.h:322-323)
and parses them back.  This is piet-tpu's persistence/interchange format --
the C++ native encoder (cc/) emits it, the C++ golden rasterizer consumes
it, the renderer consumes the parsed SoA.

Layout of a single group scene:

  offset 0:            SimpleGroup { n_items: u32, items_ix: u32 }   (8 B)
  offset 8:            n_items x ShortBbox([u16; 4])                 (8 B ea)
  offset items_ix:     n_items x PietItem (32-byte tagged union)
  after group block:   out-of-line data, bump-allocated in item order:
                       points ((f32, f32) pairs), then the item's gradient
                       payload (8 x f32) if any, then its clip rect
                       (4 x f32) if any

Item layouts (field offsets per cc/gen/piet_scene_gen.h, single-sourced in
layout/modules.py).  REFERENCE variants -- extension fields ride words the
reference zero-fills, so reference scenes encode byte-identically (a byte
ref of 0, the group header, means "absent"):

  Circle  (tag 1): tag@0 flags@4 clip_ix@8
  Line    (tag 2): tag@0 flags@4 rgba@8 width@12 start@16 end@24
                   (all 32 bytes used: a rect-clipped line spills to
                   LineExt, tag 8 below)
  Fill    (tag 3): tag@0 flags@4 rgba@8 n_points@12 points_ix@16
                   grad_ix@20 clip_ix@24
  Poly    (tag 4): tag@0 rgba@4 width@8 n_points@12 points_ix@16
                   flags@20 clip_ix@24

EXTENSION variants (piet-tpu items with no reference analog; tags continue
the reference numbering):

  Clip    (tag 5): tag@0 flags@4 n_points@8 points_ix@12   (path clip push)
  Pop     (tag 6): tag@0 flags@4 alpha@8                   (end clip/layer)
  Layer   (tag 7): tag@0 flags@4 alpha@8                   (opacity layer)
  LineExt (tag 8): tag@0 flags@4 rgba@8 width@12 points_ix@16 clip_ix@20
                   (a Line whose clip rect forced its 2 points out-of-line)

``flags`` carries the Scene.flags word verbatim (scene.py: even-odd bit 0,
in-group, pop-layer, brush kind, combined-fill bits).  Colors are stored
byte-swapped (``rgba.to_be()``, src/lib.rs:181) so the in-memory byte order
is R,G,B,A.  Gradient payloads are the Scene.grads row verbatim (host-
precomputed params + the second stop's LINEAR rgba); clip payloads are the
Scene.clips rect (4 x f32).
"""

from __future__ import annotations

import struct
import numpy as np

from .scene import (FLAG_BRUSH_LINEAR, FLAG_BRUSH_RADIAL, FLAG_POP_LAYER,
                    Scene, SceneBuilder, TAG_CIRCLE, TAG_CLIP, TAG_FILL,
                    TAG_LAYER, TAG_LINE, TAG_POLY, TAG_POP)

SIMPLE_GROUP_HEADER_SIZE = 8   # Rust struct SimpleGroup (src/lib.rs:17-20)
SHORT_BBOX_SIZE = 8
PIET_ITEM_SIZE = 32            # GenTypes.h:323
POINT_SIZE = 8
GRAD_PAYLOAD_SIZE = 32         # 8 x f32 (Scene.grads row)
CLIP_PAYLOAD_SIZE = 16         # 4 x f32 rect

#: Wire-only tag: a TAG_LINE item carrying a rect clip (the inline Line
#: layout has no free word, so its points spill out-of-line).  In the SoA
#: it is an ordinary TAG_LINE with a non-default Scene.clips row.
TAG_LINE_EXT = 8


def _has_clip(scene: Scene) -> np.ndarray:
    from ..raster.ptcl import NO_CLIP
    return ~(scene.clips == np.asarray(NO_CLIP, np.float32)).all(axis=1)


def encode_scene(scene: Scene) -> bytes:
    """Serialize to the reference byte format (+ tagged extension items)."""
    n = scene.n_items
    items_ix = SIMPLE_GROUP_HEADER_SIZE + n * SHORT_BBOX_SIZE
    group_block = items_ix + n * PIET_ITEM_SIZE
    has_clip = _has_clip(scene)
    is_grad = (scene.flags
               & np.uint32(FLAG_BRUSH_LINEAR | FLAG_BRUSH_RADIAL)) != 0

    # Pre-compute out-of-line offsets, replicating the reference's bump
    # allocation (points appended in item order, src/lib.rs:224-240; each
    # item's gradient / clip payload follows its points).
    pt_byte_ix = np.zeros(n, np.int64)
    grad_byte_ix = np.zeros(n, np.int64)
    clip_byte_ix = np.zeros(n, np.int64)
    cursor = group_block
    for i in range(n):
        tag = int(scene.tags[i])
        if tag in (TAG_FILL, TAG_POLY, TAG_CLIP) or (
                tag == TAG_LINE and has_clip[i]):
            pt_byte_ix[i] = cursor
            cursor += int(scene.n_pts[i]) * POINT_SIZE
        if is_grad[i]:
            grad_byte_ix[i] = cursor
            cursor += GRAD_PAYLOAD_SIZE
        if has_clip[i]:
            clip_byte_ix[i] = cursor
            cursor += CLIP_PAYLOAD_SIZE

    out = bytearray(cursor)
    struct.pack_into("<II", out, 0, n, items_ix)

    def put_points(i: int) -> None:
        off = int(scene.pt_offset[i])
        npts = int(scene.n_pts[i])
        pts = scene.points[off:off + npts].astype("<f4")
        out[pt_byte_ix[i]:pt_byte_ix[i] + npts * POINT_SIZE] = pts.tobytes()

    for i in range(n):
        bx = scene.bboxes[i]
        struct.pack_into("<4H", out, SIMPLE_GROUP_HEADER_SIZE + i * SHORT_BBOX_SIZE,
                         int(bx[0]), int(bx[1]), int(bx[2]), int(bx[3]))
        base = items_ix + i * PIET_ITEM_SIZE
        tag = int(scene.tags[i])
        flags = int(scene.flags[i])
        color_be = struct.unpack("<I", struct.pack(">I", int(scene.colors[i])))[0]
        npts = int(scene.n_pts[i])
        if tag == TAG_CIRCLE:
            struct.pack_into("<III", out, base, tag, flags,
                             int(clip_byte_ix[i]))
        elif tag == TAG_LINE:
            off = int(scene.pt_offset[i])
            if has_clip[i]:
                struct.pack_into("<IIIfII", out, base, TAG_LINE_EXT, flags,
                                 color_be, float(scene.widths[i]),
                                 int(pt_byte_ix[i]), int(clip_byte_ix[i]))
                put_points(i)
            else:
                p0 = scene.points[off]
                p1 = scene.points[off + 1]
                struct.pack_into("<IIIf4f", out, base, tag, flags, color_be,
                                 float(scene.widths[i]),
                                 float(p0[0]), float(p0[1]),
                                 float(p1[0]), float(p1[1]))
        elif tag == TAG_FILL:
            struct.pack_into("<IIIIIII", out, base, tag, flags, color_be,
                             npts, int(pt_byte_ix[i]), int(grad_byte_ix[i]),
                             int(clip_byte_ix[i]))
            put_points(i)
        elif tag == TAG_POLY:
            struct.pack_into("<IIfIIII", out, base, tag, color_be,
                             float(scene.widths[i]), npts,
                             int(pt_byte_ix[i]), flags, int(clip_byte_ix[i]))
            put_points(i)
        elif tag == TAG_CLIP:
            struct.pack_into("<IIII", out, base, tag, flags, npts,
                             int(pt_byte_ix[i]))
            put_points(i)
        elif tag in (TAG_POP, TAG_LAYER):
            struct.pack_into("<IIf", out, base, tag, flags,
                             float(scene.widths[i]))
        else:
            raise ValueError(f"unknown item tag {tag}")
        if is_grad[i]:
            out[grad_byte_ix[i]:grad_byte_ix[i] + GRAD_PAYLOAD_SIZE] = (
                scene.grads[i].astype("<f4").tobytes())
        if has_clip[i]:
            out[clip_byte_ix[i]:clip_byte_ix[i] + CLIP_PAYLOAD_SIZE] = (
                scene.clips[i].astype("<f4").tobytes())
    return bytes(out)


def hexdump_scene(buf: bytes) -> str:
    """Wire-format debugging aid: hexdump the encoded buffer as u32 words,
    the port of the reference's ``Encoder::debug_print``
    (src/lib.rs:242-253) -- plus region annotations the reference lacked
    (header / bbox array / item array / point data), derived from the
    self-describing header.

    Dead-pad words at the buffer tail (len % 4) are ignored, matching the
    reference's word-count truncation.
    """
    n, items_ix = struct.unpack_from("<II", buf, 0)
    group_end = items_ix + n * PIET_ITEM_SIZE
    words = np.frombuffer(buf[:len(buf) & ~3], dtype="<u4")
    lines = []
    for w0 in range(0, len(words), 4):
        byte0 = w0 * 4
        if byte0 == 0:
            region = "group header"
        elif byte0 < items_ix:
            region = f"bbox[{(byte0 - SIMPLE_GROUP_HEADER_SIZE) // SHORT_BBOX_SIZE}]"
        elif byte0 < group_end:
            region = f"item[{(byte0 - items_ix) // PIET_ITEM_SIZE}]"
        else:
            region = "points"
        row = " ".join(f"{w:08x}" for w in words[w0:w0 + 4])
        lines.append(f"{byte0:6x}: {row:<36}  {region}")
    return "\n".join(lines)


def decode_scene(buf: bytes) -> Scene:
    """Parse the reference byte format back into an SoA `Scene`.

    Items are replayed through `SceneBuilder` in wire order (which
    reproduces the original per-item point layout, including the dummy
    points of Layer/Pop items), then the exact on-wire bbox / flags /
    clip / gradient state is patched over the builder's recomputation.
    """
    n, items_ix = struct.unpack_from("<II", buf, 0)
    b = SceneBuilder()
    b.begin_group(n)

    def read_pts(npts, pix):
        return np.frombuffer(buf, dtype="<f4", count=npts * 2,
                             offset=pix).reshape(npts, 2)

    def read_clip(cix):
        if cix == 0:
            return None
        return tuple(float(v) for v in
                     np.frombuffer(buf, dtype="<f4", count=4, offset=cix))

    def read_grad(gix):
        if gix == 0:
            return None
        return tuple(float(v) for v in
                     np.frombuffer(buf, dtype="<f4", count=8, offset=gix))

    for i in range(n):
        bbox = struct.unpack_from(
            "<4H", buf, SIMPLE_GROUP_HEADER_SIZE + i * SHORT_BBOX_SIZE)
        base = items_ix + i * PIET_ITEM_SIZE
        (tag,) = struct.unpack_from("<I", buf, base)
        clip = None
        grad = None
        if tag == TAG_CIRCLE:
            _, flags, cix = struct.unpack_from("<III", buf, base)
            clip = read_clip(cix)
            # Geometry is bbox-only on the wire; reconstruct center/radius
            # the way the fine kernel does (PietRender.metal:483-490).
            x0, y0, x1, y1 = bbox
            cx, cy = (x0 + x1) / 2.0, (y0 + y1) / 2.0
            r = min(cx - x0, cy - y0)
            b.circle(cx, cy, r)
        elif tag == TAG_LINE:
            _, flags, color_be, width, x0, y0, x1, y1 = struct.unpack_from(
                "<IIIf4f", buf, base)
            rgba = struct.unpack("<I", struct.pack(">I", color_be))[0]
            b.stroke_line((x0, y0), (x1, y1), width, rgba)
        elif tag == TAG_LINE_EXT:
            _, flags, color_be, width, pix, cix = struct.unpack_from(
                "<IIIfII", buf, base)
            rgba = struct.unpack("<I", struct.pack(">I", color_be))[0]
            clip = read_clip(cix)
            pts = read_pts(2, pix)
            b.stroke_line(tuple(pts[0]), tuple(pts[1]), width, rgba)
        elif tag == TAG_FILL:
            _, flags, color_be, npts, pix, gix, cix = struct.unpack_from(
                "<IIIIIII", buf, base)
            rgba = struct.unpack("<I", struct.pack(">I", color_be))[0]
            clip = read_clip(cix)
            grad = read_grad(gix)
            # Replay as a plain solid fill; the exact wire flags word
            # (fill rule, brush kind, combined-fill bits) and the raw
            # gradient payload are patched below -- the payload is the
            # host-precomputed form, not re-derivable brush geometry.
            b.fill([tuple(p) for p in read_pts(npts, pix)], rgba)
        elif tag == TAG_POLY:
            _, color_be, width, npts, pix, flags, cix = struct.unpack_from(
                "<IIfIIII", buf, base)
            rgba = struct.unpack("<I", struct.pack(">I", color_be))[0]
            clip = read_clip(cix)
            b.polyline([tuple(p) for p in read_pts(npts, pix)], rgba, width)
        elif tag == TAG_CLIP:
            _, flags, npts, pix = struct.unpack_from("<IIII", buf, base)
            b.clip_path([tuple(p) for p in read_pts(npts, pix)])
        elif tag == TAG_LAYER:
            _, flags, alpha = struct.unpack_from("<IIf", buf, base)
            b.push_layer(alpha)
        elif tag == TAG_POP:
            _, flags, alpha = struct.unpack_from("<IIf", buf, base)
            b.pop()
            b._widths[-1] = alpha  # wire alpha wins over the replayed stack
        else:
            raise ValueError(f"unknown item tag {tag} at item {i}")
        # Preserve the exact on-wire state (builder recomputes; overwrite).
        b._bboxes[-1] = tuple(int(v) for v in bbox)
        b._flags[-1] = flags
        if clip is not None:
            b._clips[-1] = clip
        if grad is not None:
            b._grads[-1] = grad
    b.end_group()
    return b.build()
