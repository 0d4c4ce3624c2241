"""Host-side scene construction: append primitives in Python, then freeze
into padded SoA **host (numpy)** arrays.

The frozen Scene stays on the host so accelerator builds (ops/bvh.py,
ops/block_bvh.py) run as pure numpy with zero device round-trips.  The
accelerator `build()` functions (and `Renderer`) ship the finished scene to
the device in a single `jax.device_put`; numpy-backed scenes also work
directly under jit (JAX transfers them per call), which is what the CPU
test meshes use.

This plays the role of the reference's mutable `MobileRT::Scene` container
(reference app/MobileRT/Scene.hpp:20-63) during scene setup; `build()`
produces the immutable `types.Scene` pytree the kernels consume.
"""
from __future__ import annotations

import numpy as np

from . import constants as C
from .types import (Lights, Materials, Planes, Scene, Spheres, TextureAtlas,
                    Triangles, empty_texture_atlas)


def _pad_rows(arr: np.ndarray, capacity: int, fill: float = 0.0) -> np.ndarray:
    out = np.full((capacity,) + arr.shape[1:], fill, dtype=arr.dtype)
    if arr.shape[0]:
        out[: arr.shape[0]] = arr
    return out


def _round_capacity(n: int, multiple: int = 8) -> int:
    n = max(n, 1)
    return ((n + multiple - 1) // multiple) * multiple


class SceneBuilder:
    def __init__(self):
        self._tri = []          # list of dicts
        self._tri_bulk = []     # list of dict-of-arrays batches
        self._sph = []
        self._pla = []
        self._mat = []          # list of (le, kd, ks, kt, ior, tex_id)
        self._lights = []
        self._textures = []     # list of HxWx3 float arrays

    # -- materials ---------------------------------------------------------
    def add_material(self, kd=(0, 0, 0), ks=(0, 0, 0), kt=(0, 0, 0),
                     ior=1.0, le=(0, 0, 0), tex_id=-1, dedup=False) -> int:
        """Appends a material and returns its index.  With dedup=True reuses
        a value-equal material like the reference OBJ loader (reference
        app/Components/Loaders/OBJLoader.cpp:406-418)."""
        entry = (tuple(np.float32(le)), tuple(np.float32(kd)),
                 tuple(np.float32(ks)), tuple(np.float32(kt)),
                 np.float32(ior), int(tex_id))
        if dedup:
            for i, e in enumerate(self._mat):
                if e == entry:
                    return i
        self._mat.append(entry)
        return len(self._mat) - 1

    # -- geometry ----------------------------------------------------------
    def add_triangle(self, a, b, c, mat_id, normals=None, uvs=None) -> int:
        """Adds a triangle; defaults the normals to normalize(cross(AC, AB))
        like the reference builder (reference app/MobileRT/Shapes/
        Triangle.cpp:328-339)."""
        a = np.asarray(a, np.float32)
        ab = np.asarray(b, np.float32) - a
        ac = np.asarray(c, np.float32) - a
        if normals is None:
            n = np.cross(ac, ab)
            n = n / np.linalg.norm(n)
            normals = (n, n, n)
        if uvs is None:
            uvs = ((-1.0, -1.0),) * 3
        self._tri.append(dict(
            point_a=a, ab=ab, ac=ac,
            na=np.asarray(normals[0], np.float32),
            nb=np.asarray(normals[1], np.float32),
            nc=np.asarray(normals[2], np.float32),
            uva=np.asarray(uvs[0], np.float32),
            uvb=np.asarray(uvs[1], np.float32),
            uvc=np.asarray(uvs[2], np.float32),
            mat_id=int(mat_id)))
        return len(self._tri) - 1

    def add_triangles_bulk(self, point_a, ab, ac, na, nb, nc, uva, uvb, uvc,
                           mat_id) -> None:
        """Appends a whole numpy triangle batch at once (OBJ loader path —
        per-item Python loops would be far too slow at conference scale)."""
        self._tri_bulk.append(dict(
            point_a=np.asarray(point_a, np.float32),
            ab=np.asarray(ab, np.float32), ac=np.asarray(ac, np.float32),
            na=np.asarray(na, np.float32), nb=np.asarray(nb, np.float32),
            nc=np.asarray(nc, np.float32),
            uva=np.asarray(uva, np.float32), uvb=np.asarray(uvb, np.float32),
            uvc=np.asarray(uvc, np.float32),
            mat_id=np.asarray(mat_id, np.int32)))

    def add_sphere(self, center, radius, mat_id) -> int:
        self._sph.append(dict(
            center=np.asarray(center, np.float32),
            sq_radius=np.float32(radius) ** 2,
            mat_id=int(mat_id)))
        return len(self._sph) - 1

    def add_plane(self, point, normal, mat_id) -> int:
        normal = np.asarray(normal, np.float32)
        normal = normal / np.linalg.norm(normal)
        self._pla.append(dict(
            point=np.asarray(point, np.float32), normal=normal,
            mat_id=int(mat_id)))
        return len(self._pla) - 1

    # -- lights ------------------------------------------------------------
    def add_point_light(self, position, radiance) -> int:
        self._lights.append(dict(
            kind=C.LIGHT_POINT,
            position=np.asarray(position, np.float32),
            tri_a=np.zeros(3, np.float32),
            tri_ab=np.zeros(3, np.float32),
            tri_ac=np.zeros(3, np.float32),
            radiance=np.asarray(radiance, np.float32)))
        return len(self._lights) - 1

    def add_area_light(self, a, b, c, radiance) -> int:
        """Triangle emitter (reference app/Components/Lights/AreaLight.cpp)."""
        a = np.asarray(a, np.float32)
        self._lights.append(dict(
            kind=C.LIGHT_AREA,
            position=a,
            tri_a=a,
            tri_ab=np.asarray(b, np.float32) - a,
            tri_ac=np.asarray(c, np.float32) - a,
            radiance=np.asarray(radiance, np.float32)))
        return len(self._lights) - 1

    # -- textures ----------------------------------------------------------
    def add_texture(self, image: np.ndarray) -> int:
        """Adds an (H, W, 3) float image in [0,1]; returns its atlas id."""
        self._textures.append(np.asarray(image, np.float32))
        return len(self._textures) - 1

    # -- freeze ------------------------------------------------------------
    def build(self) -> Scene:
        # Merge singly-added triangles and bulk batches into one dict of
        # numpy arrays.
        keys = ("point_a", "ab", "ac", "na", "nb", "nc",
                "uva", "uvb", "uvc", "mat_id")
        shapes = {"uva": (2,), "uvb": (2,), "uvc": (2,), "mat_id": ()}
        tdata = {}
        for k in keys:
            dt = np.int32 if k == "mat_id" else np.float32
            parts = []
            if self._tri:
                parts.append(np.asarray([t[k] for t in self._tri], dt))
            parts.extend(np.asarray(b[k], dt) for b in self._tri_bulk)
            if parts:
                tdata[k] = np.concatenate(parts, 0)
            else:
                tdata[k] = np.zeros((0,) + shapes.get(k, (3,)), dt)
        num_tri = tdata["mat_id"].shape[0]
        nt = _round_capacity(num_tri)

        ns = _round_capacity(len(self._sph))
        npl = _round_capacity(len(self._pla))
        nm = _round_capacity(len(self._mat))
        nl = _round_capacity(len(self._lights))

        def stack(items, key, shape):
            if items:
                return np.stack([it[key] for it in items]).astype(np.float32)
            return np.zeros((0,) + shape, np.float32)

        tri = Triangles(
            point_a=np.asarray(_pad_rows(tdata["point_a"], nt)),
            ab=np.asarray(_pad_rows(tdata["ab"], nt, 1.0)),
            ac=np.asarray(_pad_rows(tdata["ac"], nt, 1.0)),
            normal_a=np.asarray(_pad_rows(tdata["na"], nt, 1.0)),
            normal_b=np.asarray(_pad_rows(tdata["nb"], nt, 1.0)),
            normal_c=np.asarray(_pad_rows(tdata["nc"], nt, 1.0)),
            uv_a=np.asarray(_pad_rows(tdata["uva"], nt, -1.0)),
            uv_b=np.asarray(_pad_rows(tdata["uvb"], nt, -1.0)),
            uv_c=np.asarray(_pad_rows(tdata["uvc"], nt, -1.0)),
            mat_id=np.asarray(_pad_rows(tdata["mat_id"], nt)),
            valid=np.asarray(np.arange(nt) < num_tri),
        )
        sph = Spheres(
            center=np.asarray(_pad_rows(stack(self._sph, "center", (3,)), ns)),
            sq_radius=np.asarray(_pad_rows(
                np.asarray([s["sq_radius"] for s in self._sph], np.float32), ns, 1.0)),
            mat_id=np.asarray(_pad_rows(
                np.asarray([s["mat_id"] for s in self._sph], np.int32), ns)),
            valid=np.asarray(np.arange(ns) < len(self._sph)),
        )
        pla = Planes(
            point=np.asarray(_pad_rows(stack(self._pla, "point", (3,)), npl)),
            normal=np.asarray(_pad_rows(stack(self._pla, "normal", (3,)), npl, 1.0)),
            mat_id=np.asarray(_pad_rows(
                np.asarray([p["mat_id"] for p in self._pla], np.int32), npl)),
            valid=np.asarray(np.arange(npl) < len(self._pla)),
        )

        def mstack(idx, shape3=True):
            if self._mat:
                return np.asarray([m[idx] for m in self._mat], np.float32)
            return np.zeros((0, 3) if shape3 else (0,), np.float32)

        mat = Materials(
            le=np.asarray(_pad_rows(mstack(0), nm)),
            kd=np.asarray(_pad_rows(mstack(1), nm)),
            ks=np.asarray(_pad_rows(mstack(2), nm)),
            kt=np.asarray(_pad_rows(mstack(3), nm)),
            ior=np.asarray(_pad_rows(mstack(4, False), nm, 1.0)),
            tex_id=np.asarray(_pad_rows(
                np.asarray([m[5] for m in self._mat], np.int32), nm, -1)),
        )
        lights = Lights(
            kind=np.asarray(_pad_rows(
                np.asarray([l["kind"] for l in self._lights], np.int32), nl)),
            position=np.asarray(_pad_rows(stack(self._lights, "position", (3,)), nl)),
            tri_a=np.asarray(_pad_rows(stack(self._lights, "tri_a", (3,)), nl)),
            tri_ab=np.asarray(_pad_rows(stack(self._lights, "tri_ab", (3,)), nl, 1.0)),
            tri_ac=np.asarray(_pad_rows(stack(self._lights, "tri_ac", (3,)), nl, 1.0)),
            radiance=np.asarray(_pad_rows(stack(self._lights, "radiance", (3,)), nl)),
            valid=np.asarray(np.arange(nl) < len(self._lights)),
            num=np.asarray(len(self._lights), np.int32),
        )

        if self._textures:
            h = max(t.shape[0] for t in self._textures)
            w = max(t.shape[1] for t in self._textures)
            data = np.zeros((len(self._textures), h, w, 3), np.float32)
            sizes = np.zeros((len(self._textures), 2), np.int32)
            for i, t in enumerate(self._textures):
                data[i, : t.shape[0], : t.shape[1]] = t
                sizes[i] = (t.shape[0], t.shape[1])
            atlas = TextureAtlas(data=np.asarray(data), sizes=np.asarray(sizes))
        else:
            atlas = empty_texture_atlas()

        return Scene(triangles=tri, spheres=sph, planes=pla, materials=mat,
                     lights=lights, atlas=atlas, bvh=None)
