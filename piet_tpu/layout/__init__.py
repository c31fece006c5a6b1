"""Layout codegen: single-source-of-truth packed struct layouts.

The equivalent of the reference's piet-gpu-derive proc-macro system
(C5-C7 in SURVEY.md section 2)."""

from .dsl import Enum, Field, Module, Ref, Scalar, Struct, Vector
from .emit_cpp import emit_cpp
from .emit_py import describe
from .modules import ptcl_module, scene_module
from .packing import pack_module, pack_struct

__all__ = ["Enum", "Field", "Module", "Ref", "Scalar", "Struct", "Vector",
           "emit_cpp", "describe", "ptcl_module", "scene_module",
           "pack_module", "pack_struct"]
