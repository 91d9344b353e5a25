"""Triangle-mesh file IO: GLB (glTF 2.0 binary), OBJ, PLY.

A numpy copy of robosimgs_tpu/utils/meshio.py (the port imports nothing
from the JAX package). Meshes are numpy on both sides, so files written
by either package read the same in the other and no converter is needed.
PIL is imported only where a GLB embeds a texture image.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class Mesh:
    vertices: np.ndarray                      # (V, 3) float32
    faces: np.ndarray                         # (F, 3) int32
    vertex_colors: Optional[np.ndarray] = None  # (V, 3) float32 in [0,1]
    uv: Optional[np.ndarray] = None           # (V, 2) float32 texcoords
    texture: Optional[np.ndarray] = None      # (Th, Tw, 3) float32 in [0,1]

    @property
    def bounds(self) -> np.ndarray:
        """(2, 3) [min; max] corner bounds."""
        return np.stack([self.vertices.min(0), self.vertices.max(0)])

    @property
    def center(self) -> np.ndarray:
        """Center of the bounding box."""
        b = self.bounds
        return (b[0] + b[1]) / 2.0

    @property
    def centroid(self) -> np.ndarray:
        """Mean vertex position."""
        return self.vertices.mean(0)

    def translated(self, offset) -> "Mesh":
        return dataclasses.replace(
            self, vertices=self.vertices + np.asarray(offset, np.float32))

    def transformed(self, T: np.ndarray) -> "Mesh":
        """Apply a (4, 4) homogeneous transform."""
        T = np.asarray(T, np.float32)
        v = self.vertices @ T[:3, :3].T + T[:3, 3]
        return dataclasses.replace(self, vertices=v.astype(np.float32))

    def face_normals(self) -> np.ndarray:
        v = self.vertices
        f = self.faces
        n = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
        norm = np.linalg.norm(n, axis=1, keepdims=True)
        return n / np.clip(norm, 1e-12, None)

    def face_areas(self) -> np.ndarray:
        v = self.vertices
        f = self.faces
        n = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
        return 0.5 * np.linalg.norm(n, axis=1)

    def face_centroids(self) -> np.ndarray:
        return self.vertices[self.faces].mean(1)

    def submesh(self, face_mask: np.ndarray) -> "Mesh":
        """Extract faces (bool mask or index array), re-indexing vertices."""
        faces = self.faces[face_mask]
        used, inverse = np.unique(faces.reshape(-1), return_inverse=True)
        new_faces = inverse.reshape(-1, 3).astype(np.int32)
        vc = self.vertex_colors[used] if self.vertex_colors is not None else None
        uv = self.uv[used] if self.uv is not None else None
        return Mesh(vertices=self.vertices[used].copy(), faces=new_faces,
                    vertex_colors=vc, uv=uv, texture=self.texture)

    def baked_vertex_colors(self) -> Optional[np.ndarray]:
        """(V, 3) colors at vertex resolution: the glTF base-color
        PRODUCT of vertex colors and the texture sampled at each
        vertex's UV (either term alone when the other is absent) — the
        color source for splat init / shaded views."""
        tex = (sample_texture(self.texture, self.uv)
               if self.uv is not None and self.texture is not None else None)
        if self.vertex_colors is not None and tex is not None:
            return (self.vertex_colors * tex).astype(np.float32)
        if self.vertex_colors is not None:
            return self.vertex_colors
        return tex

    def _sample_barycentric(self, n: int, seed: int):
        rng = np.random.default_rng(seed)
        areas = self.face_areas()
        p = areas / areas.sum()
        fi = rng.choice(len(p), size=n, p=p)
        r1 = np.sqrt(rng.uniform(size=(n, 1)))
        r2 = rng.uniform(size=(n, 1))
        w = np.concatenate([1 - r1, r1 * (1 - r2), r1 * r2], axis=1)
        return fi, w.astype(np.float32)                # (n,), (n, 3)

    def sample_surface(self, n: int, seed: int = 0) -> np.ndarray:
        """Area-weighted uniform surface samples (n, 3) — the headless
        replacement for Open3D's sample_points_uniformly."""
        fi, w = self._sample_barycentric(n, seed)
        tri = self.vertices[self.faces[fi]]
        return np.einsum("ni,nic->nc", w, tri).astype(np.float32)

    def sample_surface_colored(self, n: int, seed: int = 0):
        """(points (n, 3), colors (n, 3) or None): surface samples with
        appearance — texture sampled at the interpolated UV when the
        mesh is textured, else interpolated vertex colors. The splat
        initializer for textured scans."""
        fi, w = self._sample_barycentric(n, seed)
        tri = self.vertices[self.faces[fi]]
        pts = np.einsum("ni,nic->nc", w, tri).astype(np.float32)
        tex = None
        if self.uv is not None and self.texture is not None:
            uv = np.einsum("ni,nic->nc", w, self.uv[self.faces[fi]])
            tex = sample_texture(self.texture, uv)
        col = None
        if self.vertex_colors is not None:
            col = np.einsum("ni,nic->nc", w,
                            self.vertex_colors[self.faces[fi]]).astype(
                np.float32)
        if col is not None and tex is not None:   # glTF: the product
            return pts, (col * tex).astype(np.float32)
        return pts, (col if col is not None else tex)


def sample_texture(texture: np.ndarray, uv: np.ndarray) -> np.ndarray:
    """Bilinear texture sample at (N, 2) UVs (glTF REPEAT wrap,
    v down from the image top). Returns (N, 3) float32."""
    th, tw = texture.shape[:2]
    x = np.asarray(uv[:, 0], np.float64) * tw - 0.5
    y = np.asarray(uv[:, 1], np.float64) * th - 0.5
    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    x0m, x1m = x0 % tw, (x0 + 1) % tw
    y0m, y1m = y0 % th, (y0 + 1) % th
    t = texture.astype(np.float32)
    c00, c01 = t[y0m, x0m], t[y0m, x1m]
    c10, c11 = t[y1m, x0m], t[y1m, x1m]
    top = c00 * (1 - fx) + c01 * fx
    bot = c10 * (1 - fx) + c11 * fx
    return (top * (1 - fy) + bot * fy).astype(np.float32)


def concatenate(meshes: List[Mesh]) -> Mesh:
    offs = 0
    vs, fs, cs, uvs = [], [], [], []
    # a shared texture survives concatenation only when every part uses
    # the SAME texture array and carries UVs; otherwise per-part
    # textures are baked to vertex colors (appearance at vertex
    # resolution) so multi-material scans still load with color
    textures = [m.texture for m in meshes if m.texture is not None]
    shared_tex = (len(textures) == len(meshes) and len(meshes) > 0
                  and all(t is textures[0] or
                          (t.shape == textures[0].shape
                           and np.array_equal(t, textures[0]))
                          for t in textures)
                  and all(m.uv is not None for m in meshes))
    baked = [m.baked_vertex_colors() if not shared_tex else m.vertex_colors
             for m in meshes]
    has_color = any(c is not None for c in baked)
    for m, c in zip(meshes, baked):
        vs.append(m.vertices)
        fs.append(m.faces + offs)
        if has_color:
            # under a kept shared texture the color channel MULTIPLIES
            # the texture, so a colorless part's neutral fill is white
            # (matching its solo rendering), not the 0.7 gray used for
            # untextured scenes
            fill = 1.0 if shared_tex else 0.7
            cs.append(c if c is not None else np.full_like(m.vertices, fill))
        if shared_tex:
            uvs.append(m.uv)
        offs += m.vertices.shape[0]
    return Mesh(vertices=np.concatenate(vs), faces=np.concatenate(fs),
                vertex_colors=np.concatenate(cs) if has_color else None,
                uv=np.concatenate(uvs) if shared_tex else None,
                texture=textures[0] if shared_tex else None)


def load_mesh(path: str) -> Mesh:
    ext = os.path.splitext(path)[1].lower()
    if ext in (".glb", ".gltf"):
        return _load_glb(path)
    if ext == ".obj":
        return _load_obj(path)
    if ext == ".ply":
        return _load_ply_mesh(path)
    raise ValueError(f"unsupported mesh format {ext}")


def save_mesh(path: str, mesh: Mesh) -> None:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".glb":
        return _save_glb(path, mesh)
    if ext == ".obj":
        return _save_obj(path, mesh)
    if ext == ".ply":
        return _save_ply_mesh(path, mesh)
    raise ValueError(f"unsupported mesh format {ext}")


# -- GLB ------------------------------------------------------------------

_CT = {5120: np.int8, 5121: np.uint8, 5122: np.int16, 5123: np.uint16,
       5125: np.uint32, 5126: np.float32}
_NC = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


def _load_glb(path: str) -> Mesh:
    with open(path, "rb") as fh:
        magic, version, _ = struct.unpack("<III", fh.read(12))
        if magic != 0x46546C67:
            # maybe a .gltf JSON with external buffer — unsupported embedded-only
            fh.seek(0)
            gltf = json.load(fh)
            raise ValueError("external-buffer .gltf unsupported; use .glb")
        gltf = None
        binary = b""
        while True:
            head = fh.read(8)
            if len(head) < 8:
                break
            length, ctype = struct.unpack("<II", head)
            data = fh.read(length)
            if ctype == 0x4E4F534A:
                gltf = json.loads(data.decode("utf-8"))
            elif ctype == 0x004E4942:
                binary = data

    def read_accessor(idx: int) -> np.ndarray:
        acc = gltf["accessors"][idx]
        view = gltf["bufferViews"][acc["bufferView"]]
        dtype = _CT[acc["componentType"]]
        ncomp = _NC[acc["type"]]
        offset = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
        count = acc["count"]
        stride = view.get("byteStride")
        itemsize = np.dtype(dtype).itemsize * ncomp
        if stride and stride != itemsize:
            raw = np.frombuffer(binary, np.uint8,
                                count=stride * (count - 1) + itemsize,
                                offset=offset)
            out = np.zeros((count, itemsize), np.uint8)
            for i in range(count):
                out[i] = raw[i * stride: i * stride + itemsize]
            arr = out.view(dtype).reshape(count, ncomp)
        else:
            arr = np.frombuffer(binary, dtype, count=count * ncomp,
                                offset=offset).reshape(count, ncomp)
        if acc.get("normalized") and dtype != np.float32:
            arr = arr.astype(np.float32) / np.iinfo(dtype).max
        return arr

    def node_transform(node: dict) -> np.ndarray:
        if "matrix" in node:
            return np.asarray(node["matrix"], np.float32).reshape(4, 4).T
        T = np.eye(4, dtype=np.float32)
        if "rotation" in node:  # glTF xyzw
            x, y, z, w = node["rotation"]
            q = np.array([w, x, y, z], np.float32)
            q /= np.linalg.norm(q)
            w, x, y, z = q
            T[:3, :3] = np.array([
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
        if "scale" in node:
            T[:3, :3] = T[:3, :3] * np.asarray(node["scale"], np.float32)[None, :]
        if "translation" in node:
            T[:3, 3] = node["translation"]
        return T

    _image_cache: dict = {}

    def read_image(img_idx: int) -> Optional[np.ndarray]:
        """Decode images[img_idx] (PNG/JPEG in a bufferView) to (H, W, 3)
        float32 in [0, 1]; None when undecodable or external-URI."""
        if img_idx in _image_cache:
            return _image_cache[img_idx]
        img = gltf["images"][img_idx]
        out = None
        if "bufferView" in img:
            view = gltf["bufferViews"][img["bufferView"]]
            off = view.get("byteOffset", 0)
            data = binary[off: off + view["byteLength"]]
            try:
                import io

                from PIL import Image
                pil = Image.open(io.BytesIO(data)).convert("RGB")
                out = np.asarray(pil, np.float32) / 255.0
            except Exception:
                out = None
        _image_cache[img_idx] = out
        return out

    def read_base_color(prim: dict):
        """(texture (H, W, 3) or None, factor (3,)) from the primitive's
        material pbrMetallicRoughness base color."""
        factor = np.ones(3, np.float32)
        tex = None
        mi = prim.get("material")
        if mi is None:
            return tex, factor
        pbr = gltf.get("materials", [{}])[mi].get("pbrMetallicRoughness", {})
        if "baseColorFactor" in pbr:
            factor = np.asarray(pbr["baseColorFactor"][:3], np.float32)
        bct = pbr.get("baseColorTexture")
        if bct is not None:
            src = gltf["textures"][bct["index"]].get("source")
            if src is not None:
                tex = read_image(src)
        return tex, factor

    parts: List[Mesh] = []

    def load_prim(prim: dict) -> Mesh:
        pos = read_accessor(prim["attributes"]["POSITION"]).astype(np.float32)
        if "indices" in prim:
            idx = read_accessor(prim["indices"]).reshape(-1).astype(np.int32)
        else:
            idx = np.arange(pos.shape[0], dtype=np.int32)
        faces = idx.reshape(-1, 3)
        colors = None
        if "COLOR_0" in prim["attributes"]:
            c = read_accessor(prim["attributes"]["COLOR_0"]).astype(np.float32)
            colors = c[:, :3]
        uv = None
        if "TEXCOORD_0" in prim["attributes"]:
            uv = read_accessor(
                prim["attributes"]["TEXCOORD_0"]).astype(np.float32)[:, :2]
        tex, factor = read_base_color(prim)
        if tex is not None and uv is None:
            tex = None  # texture unusable without texcoords
        if not np.allclose(factor, 1.0):
            if tex is not None:
                tex = tex * factor[None, None, :]
            elif colors is not None:
                colors = colors * factor[None, :]
            else:
                colors = np.broadcast_to(factor, pos.shape).copy()
        return Mesh(pos, faces, colors, uv=uv, texture=tex)

    def visit(node_idx: int, parent_T: np.ndarray):
        node = gltf["nodes"][node_idx]
        T = parent_T @ node_transform(node)
        if "mesh" in node:
            for prim in gltf["meshes"][node["mesh"]]["primitives"]:
                parts.append(load_prim(prim).transformed(T))
        for child in node.get("children", []):
            visit(child, T)

    scene = gltf.get("scenes", [{}])[gltf.get("scene", 0)]
    roots = scene.get("nodes")
    I = np.eye(4, dtype=np.float32)
    if roots:
        for r in roots:
            visit(r, I)
    else:  # no scene graph: read all mesh primitives directly
        for mesh in gltf.get("meshes", []):
            for prim in mesh["primitives"]:
                parts.append(load_prim(prim))
    if not parts:
        raise ValueError(f"no triangle meshes in {path}")
    return concatenate(parts) if len(parts) > 1 else parts[0]


def _save_glb(path: str, mesh: Mesh) -> None:
    pos = np.ascontiguousarray(mesh.vertices, np.float32)
    idx = np.ascontiguousarray(mesh.faces.reshape(-1), np.uint32)
    chunks = [pos.tobytes(), idx.tobytes()]
    attrs = {"POSITION": 0}
    pmin = pos.min(0).tolist() if pos.shape[0] else [0.0, 0.0, 0.0]
    pmax = pos.max(0).tolist() if pos.shape[0] else [0.0, 0.0, 0.0]
    accessors = [
        {"bufferView": 0, "componentType": 5126, "count": int(pos.shape[0]),
         "type": "VEC3", "min": pmin, "max": pmax},
        {"bufferView": 1, "componentType": 5125, "count": int(idx.shape[0]),
         "type": "SCALAR"},
    ]
    views = []
    off = 0
    for i, ch in enumerate(chunks):
        views.append({"buffer": 0, "byteOffset": off, "byteLength": len(ch)})
        off += len(ch) + (-len(ch)) % 4

    def add_chunk(ch: bytes) -> int:
        nonlocal off
        chunks.append(ch)
        views.append({"buffer": 0, "byteOffset": off, "byteLength": len(ch)})
        off += len(ch) + (-len(ch)) % 4
        return len(views) - 1

    if mesh.vertex_colors is not None:
        col = np.ascontiguousarray(mesh.vertex_colors, np.float32)
        vi = add_chunk(col.tobytes())
        attrs["COLOR_0"] = len(accessors)
        accessors.append({"bufferView": vi, "componentType": 5126,
                          "count": int(col.shape[0]), "type": "VEC3"})
    gltf_extra: dict = {}
    if mesh.uv is not None:
        uvd = np.ascontiguousarray(mesh.uv, np.float32)
        vi = add_chunk(uvd.tobytes())
        attrs["TEXCOORD_0"] = len(accessors)
        accessors.append({"bufferView": vi, "componentType": 5126,
                          "count": int(uvd.shape[0]), "type": "VEC2"})
        if mesh.texture is not None:
            import io

            from PIL import Image
            img = Image.fromarray(
                np.clip(mesh.texture * 255.0, 0, 255).astype(np.uint8))
            buf = io.BytesIO()
            img.save(buf, format="PNG")
            vi = add_chunk(buf.getvalue())
            gltf_extra = {
                "images": [{"bufferView": vi, "mimeType": "image/png"}],
                "samplers": [{}],
                "textures": [{"sampler": 0, "source": 0}],
                "materials": [{"pbrMetallicRoughness":
                               {"baseColorTexture": {"index": 0}}}],
            }
    bin_data = b"".join(ch + b"\x00" * ((-len(ch)) % 4) for ch in chunks)
    prim = {"attributes": attrs, "indices": 1, "mode": 4}
    if gltf_extra:
        prim["material"] = 0
    gltf = {
        "asset": {"version": "2.0", "generator": "robosimgs_tpu_torch"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [prim]}],
        "accessors": accessors,
        "bufferViews": views,
        "buffers": [{"byteLength": len(bin_data)}],
        **gltf_extra,
    }
    js = json.dumps(gltf).encode("utf-8")
    js += b" " * ((-len(js)) % 4)
    total = 12 + 8 + len(js) + 8 + len(bin_data)
    with open(path, "wb") as fh:
        fh.write(struct.pack("<III", 0x46546C67, 2, total))
        fh.write(struct.pack("<II", len(js), 0x4E4F534A))
        fh.write(js)
        fh.write(struct.pack("<II", len(bin_data), 0x004E4942))
        fh.write(bin_data)


# -- OBJ ------------------------------------------------------------------

def _load_obj(path: str) -> Mesh:
    verts, colors, faces = [], [], []
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
                if len(parts) >= 7:
                    colors.append([float(x) for x in parts[4:7]])
            elif parts[0] == "f":
                ids = [int(p.split("/")[0]) - 1 for p in parts[1:]]
                for i in range(1, len(ids) - 1):  # fan triangulation
                    faces.append([ids[0], ids[i], ids[i + 1]])
    return Mesh(
        vertices=np.asarray(verts, np.float32),
        faces=np.asarray(faces, np.int32),
        vertex_colors=np.asarray(colors, np.float32) if len(colors) == len(verts) and colors else None,
    )


def _save_obj(path: str, mesh: Mesh) -> None:
    with open(path, "w") as fh:
        for i, v in enumerate(mesh.vertices):
            if mesh.vertex_colors is not None:
                c = mesh.vertex_colors[i]
                fh.write(f"v {v[0]} {v[1]} {v[2]} {c[0]} {c[1]} {c[2]}\n")
            else:
                fh.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for f in mesh.faces:
            fh.write(f"f {f[0]+1} {f[1]+1} {f[2]+1}\n")


# -- PLY (mesh) -----------------------------------------------------------

def _load_ply_mesh(path: str) -> Mesh:
    with open(path, "rb") as fh:
        raw = fh.read()
    end = raw.index(b"end_header\n") + len(b"end_header\n")
    header = raw[:end].decode("ascii").splitlines()
    fmt = None
    elements = []  # (name, count, [(type, name)])
    for line in header:
        p = line.split()
        if not p:
            continue
        if p[0] == "format":
            fmt = p[1]
        elif p[0] == "element":
            elements.append([p[1], int(p[2]), []])
        elif p[0] == "property":
            if p[1] == "list":
                elements[-1][2].append(("list", p[2], p[3], p[4]))
            else:
                elements[-1][2].append((p[1], p[2]))

    _PT = {"float": "f4", "float32": "f4", "double": "f8", "uchar": "u1",
           "uint8": "u1", "int": "i4", "int32": "i4", "uint": "u4",
           "uint32": "u4", "short": "i2", "ushort": "u2", "char": "i1"}

    verts = colors = faces = None
    if fmt == "ascii":
        lines = raw[end:].decode("ascii").split("\n")
        li = 0
        for name, count, props in elements:
            rows = []
            for _ in range(count):
                rows.append(lines[li].split())
                li += 1
            if name == "vertex":
                names = [p[1] for p in props]
                arr = np.asarray([[float(x) for x in r[:len(names)]] for r in rows])
                verts = arr[:, [names.index("x"), names.index("y"), names.index("z")]]
                if "red" in names:
                    colors = arr[:, [names.index("red"), names.index("green"),
                                     names.index("blue")]] / 255.0
            elif name == "face":
                faces = []
                for r in rows:
                    n = int(r[0])
                    ids = [int(x) for x in r[1:1 + n]]
                    for i in range(1, n - 1):
                        faces.append([ids[0], ids[i], ids[i + 1]])
                faces = np.asarray(faces, np.int32)
    elif fmt == "binary_little_endian":
        buf = raw[end:]
        off = 0
        for name, count, props in elements:
            if name == "vertex":
                dt = np.dtype([(p[1], "<" + _PT[p[0]]) for p in props])
                arr = np.frombuffer(buf, dt, count=count, offset=off)
                off += dt.itemsize * count
                verts = np.stack([arr["x"], arr["y"], arr["z"]], -1).astype(np.float32)
                if "red" in dt.names:
                    colors = np.stack([arr["red"], arr["green"], arr["blue"]],
                                      -1).astype(np.float32) / 255.0
            elif name == "face":
                lp = props[0]
                cnt_t = np.dtype("<" + _PT[lp[1]])
                idx_t = np.dtype("<" + _PT[lp[2]])
                faces = []
                for _ in range(count):
                    n = int(np.frombuffer(buf, cnt_t, 1, off)[0])
                    off += cnt_t.itemsize
                    ids = np.frombuffer(buf, idx_t, n, off)
                    off += idx_t.itemsize * n
                    for i in range(1, n - 1):
                        faces.append([ids[0], ids[i], ids[i + 1]])
                faces = np.asarray(faces, np.int32)
    else:
        raise ValueError(f"unsupported PLY format {fmt}")
    if verts is None:
        raise ValueError(f"no vertex element in {path}")
    return Mesh(vertices=verts.astype(np.float32),
                faces=faces if faces is not None else np.zeros((0, 3), np.int32),
                vertex_colors=colors)


def _save_ply_mesh(path: str, mesh: Mesh) -> None:
    n, f = mesh.vertices.shape[0], mesh.faces.shape[0]
    has_c = mesh.vertex_colors is not None
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if has_c:
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    header += [f"element face {f}", "property list uchar uint vertex_indices",
               "end_header"]
    with open(path, "wb") as fh:
        fh.write(("\n".join(header) + "\n").encode("ascii"))
        if has_c:
            dt = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                           ("r", "u1"), ("g", "u1"), ("b", "u1")])
            arr = np.zeros(n, dt)
            arr["x"], arr["y"], arr["z"] = mesh.vertices.T
            c = np.clip(mesh.vertex_colors * 255, 0, 255).astype(np.uint8)
            arr["r"], arr["g"], arr["b"] = c.T
        else:
            arr = mesh.vertices.astype("<f4")
        fh.write(arr.tobytes())
        fdt = np.dtype([("n", "u1"), ("a", "<u4"), ("b", "<u4"), ("c", "<u4")])
        farr = np.zeros(f, fdt)
        farr["n"] = 3
        farr["a"], farr["b"], farr["c"] = mesh.faces.astype(np.uint32).T
        fh.write(farr.tobytes())
