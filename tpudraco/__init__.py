"""tpudraco — a Draco-bitstream 3D mesh codec with a JAX device plane.

A from-scratch JAX/XLA re-design of the capabilities of
reearth/draco-oxide: Draco v2.2 encode + decode (edgebreaker and sequential
connectivity, quantization/prediction/transform attribute pipeline, rANS
entropy coding), OBJ and glTF I/O with a KHR_draco_mesh_compression
transcoder, and data-parallel batch encoding over GPU device meshes.

Layer map (mirrors SURVEY.md §1 for the reference):
  wire/     — L0 byte/bit I/O, leb128, zigzag
  models/   — L1/L2 mesh data model + corner tables (SoA numpy/JAX arrays)
  entropy/  — L3 rANS / RAbS host reference coders
  encode/   — L4/L5 connectivity + attribute encoders, top-level encode()
  decode/   — L4/L5 mirrors, top-level decode()
  io/       — L6 OBJ/glTF loaders, transcoder
  tools/    — L7 CLI + analyzer
  ops/      — device (JAX) kernels for the data plane
  parallel/ — multi-chip sharded batch driver
  native/   — C++ fast paths (rANS, traversal) via ctypes
"""

__version__ = "0.1.0"

from .models import (  # noqa: E402
    Attribute, AttributeDomain, AttributeType, ComponentType, Mesh,
    MeshBuilder,
)
# import the packages eagerly, then rebind the top-level callables so
# `tpudraco.encode(...)` / `tpudraco.decode(...)` work (the function
# attributes intentionally shadow the same-named submodules)
from . import decode as decode_mod  # noqa: E402
from . import encode as encode_mod  # noqa: E402
from .encode import Config  # noqa: E402

encode = encode_mod.encode
decode = decode_mod.decode


def load_obj(path):
    from .io import load_obj as _load
    return _load(path)
