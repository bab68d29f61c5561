"""Engine⇄renderer shared vertex types — the ``tyleri-api`` analog.

The reference consumes two vertex formats from its sibling crate
(ref: SURVEY §2 row E3; layouts fixed by the shaders):

* ``Vertex``: pos vec3 + uv vec2     (ref: src/pipeline/glsl/common_pipeline.vert:5-6)
* ``UIVertex``: pos vec2 + uv vec2 + color vec4  (ref: src/pipeline/glsl/ui.vert:3-5)

Here vertex data lives as struct-of-arrays device buffers; these
classes are thin host-side constructors/validators that pack user data into
the SoA layout the kernels consume.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Vertex:
    """One 3D mesh vertex: position (x, y, z) + texture coords (u, v)."""

    pos: tuple
    uv: tuple

    FLOATS = 5

    @staticmethod
    def pack(vertices) -> np.ndarray:
        """Pack an iterable of Vertex (or (pos, uv) pairs) into f32 [N, 5]."""
        rows = []
        for v in vertices:
            if isinstance(v, Vertex):
                rows.append([*v.pos, *v.uv])
            else:
                pos, uv = v
                rows.append([*pos, *uv])
        out = np.asarray(rows, np.float32)
        if out.size and out.shape[1] != Vertex.FLOATS:
            raise ValueError(f"Vertex rows must have {Vertex.FLOATS} floats")
        return out.reshape(-1, Vertex.FLOATS)

    @staticmethod
    def soa(packed: np.ndarray):
        """Split packed [N, 5] into (positions [N,3], uvs [N,2])."""
        packed = np.asarray(packed, np.float32).reshape(-1, Vertex.FLOATS)
        return packed[:, :3], packed[:, 3:5]


@dataclasses.dataclass(frozen=True)
class LitVertex:
    """One lit 3D mesh vertex: position + normal + texture coords.

    An extension over the reference's Vertex (its shaders are unlit —
    ref: src/pipeline/glsl/common_pipeline.frag:5-13); the BASELINE
    config-3 target names Blinn-Phong lit rendering, which needs per-vertex
    normals.  Meshes uploaded without normals shade as ambient-only when a
    scene light is enabled, and identically to the reference when not."""

    pos: tuple
    normal: tuple
    uv: tuple

    FLOATS = 8

    @staticmethod
    def pack(vertices) -> np.ndarray:
        """Pack LitVertex (or (pos, normal, uv)) into f32 [N, 8]."""
        rows = []
        for v in vertices:
            if isinstance(v, LitVertex):
                rows.append([*v.pos, *v.normal, *v.uv])
            else:
                pos, nrm, uv = v
                rows.append([*pos, *nrm, *uv])
        out = np.asarray(rows, np.float32)
        if out.size and out.shape[1] != LitVertex.FLOATS:
            raise ValueError(f"LitVertex rows must have {LitVertex.FLOATS} floats")
        return out.reshape(-1, LitVertex.FLOATS)

    @staticmethod
    def soa(packed: np.ndarray):
        """Split packed [N, 8] into (positions, normals, uvs)."""
        packed = np.asarray(packed, np.float32).reshape(-1, LitVertex.FLOATS)
        return packed[:, :3], packed[:, 3:6], packed[:, 6:8]


@dataclasses.dataclass(frozen=True)
class UIVertex:
    """One UI vertex: screen-space position in points, uv, straight rgba."""

    pos: tuple
    uv: tuple
    color: tuple

    FLOATS = 8

    @staticmethod
    def pack(vertices) -> np.ndarray:
        rows = []
        for v in vertices:
            if isinstance(v, UIVertex):
                rows.append([*v.pos, *v.uv, *v.color])
            else:
                pos, uv, color = v
                rows.append([*pos, *uv, *color])
        out = np.asarray(rows, np.float32)
        if out.size and out.shape[1] != UIVertex.FLOATS:
            raise ValueError(f"UIVertex rows must have {UIVertex.FLOATS} floats")
        return out.reshape(-1, UIVertex.FLOATS)
