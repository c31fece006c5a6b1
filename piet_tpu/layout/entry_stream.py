"""Entry-stream record layout: the device-side PTCL word map, declared once.

The coarse pass emits sorted 16-word f32 records ("entries"); the Pallas
fine kernel interprets them.  This module is the single source of truth
for the word map (the reference built its layout codegen to kill the same
bug class: src/lib.rs:13 "Keep these in sync!", piet-gpu-derive/src/lib.rs);
both kernels import these constants and
tests/test_layout.py::test_entry_stream_word_map pins the map.

Record shape (one entry = 16 f32 words, one row of the (E, 16) stream,
64 contiguous bytes):

  word 0      slot-0 command tag as f32 (0 = empty slot)
  words 1-7   slot-0 operand words 0-6
  word 8      slot-1 command tag (only ever CmdFill or 0)
  words 9-13  slot-1 operand words 0-4 (hit rows; CmdFill uses all five:
              [sx, sy, ey, m, K], the division-free fill operands)
  word 13     (candidate rows, where slot 1 is empty) opaque-solid bail
              color, present-format u32 bitcast to f32
  word 14     meta bits (see META_*)
  word 15     zero padding

Slot 0 carries FillEdge / Line / tail commands (draw-command operand words
8-11 are the clip rect, riding in words 9-12 of the record -- legal because
a record never has both a tail command and a slot-1 fill).  Slot 1 carries
the optional same-segment CmdFill (PietRender.metal emits at most one fill
+ one non-fill per segment; see ops/coarse.py's two-slot design note).
"""

from __future__ import annotations

#: Total f32 words per entry (one stream row).
ENTRY_WORDS = 16

W_S0_TAG = 0    #: slot-0 command tag (f32-encoded small int, 0 = empty)
W_S0_ARG = 1    #: slot-0 operand word k lives at W_S0_ARG + k (k in 0..6)
N_S0_ARGS = 7

W_S1_TAG = 8    #: slot-1 command tag (CmdFill or 0)
W_S1_ARG = 9    #: slot-1 operand word k lives at W_S1_ARG + k (k in 0..4)
N_S1_ARGS = 5

W_BAIL = 13     #: candidate rows: opaque-solid bail color (u32 as f32)
W_META = 14     #: meta bits (integer-valued f32)
W_PAD = 15      #: zero padding

#: META word bit layout (held exactly in f32: values < 2^4).
META_NCMDS_MASK = 0b11   #: live command count of this entry (0..2)
META_OPAQUE_BIT = 1 << 2 #: entry is an opaque solid (enables tile bail)
META_CLEAR_BIT = 1 << 3  #: entry clears accumulator state (stroke/draw end)


def _static_check() -> None:
    assert W_S0_ARG + N_S0_ARGS == W_S1_TAG
    assert W_S1_ARG + N_S1_ARGS == W_META
    assert W_BAIL == W_S1_ARG + 4  # shares slot-1 arg 4 (candidate rows
    # never carry a slot-1 fill, so the bail color cannot collide with
    # the fill's K word)
    assert W_PAD == ENTRY_WORDS - 1


_static_check()
