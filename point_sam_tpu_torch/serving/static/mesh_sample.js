// Browser-side mesh -> point cloud sampling.
// Capability parity with the reference demo's sample_pc.js (barycentric
// sampling of mesh surfaces with texture/vertex color lookup), own design:
// triangles are chosen AREA-WEIGHTED via a cumulative-area table + binary
// search (the reference samples faces uniformly, biasing density toward
// small triangles), the texture is rasterized to a canvas ONCE per mesh
// (not once per sample), and non-indexed geometry is supported.

import * as THREE from "three";

function triArea(a, b, c) {
  const ab = new THREE.Vector3().subVectors(b, a);
  const ac = new THREE.Vector3().subVectors(c, a);
  return ab.cross(ac).length() * 0.5;
}

// Uniform barycentric sample via the sqrt trick.
function randomBarycentric() {
  const u = Math.random();
  const v = Math.sqrt(Math.random());
  return [1 - v, v * (1 - u), v * u];
}

class TextureReader {
  constructor(texture) {
    const image = texture.image;
    const canvas = document.createElement("canvas");
    canvas.width = image.width;
    canvas.height = image.height;
    const ctx = canvas.getContext("2d", { willReadFrequently: true });
    ctx.drawImage(image, 0, 0, image.width, image.height);
    this.data = ctx.getImageData(0, 0, image.width, image.height).data;
    this.w = image.width;
    this.h = image.height;
  }
  at(u, v) {
    // UV origin bottom-left; canvas origin top-left; wrap repeat.
    const x = Math.min(this.w - 1,
      Math.max(0, Math.floor(((u % 1) + 1) % 1 * this.w)));
    const y = Math.min(this.h - 1,
      Math.max(0, Math.floor(((1 - v) % 1 + 1) % 1 * this.h)));
    const o = 4 * (y * this.w + x);
    return [this.data[o] / 255, this.data[o + 1] / 255, this.data[o + 2] / 255];
  }
}

function vertexIndex(geometry, face, corner) {
  const i = 3 * face + corner;
  return geometry.index ? geometry.index.array[i] : i;
}

// Sample `count` surface points from one THREE.Mesh.
// Returns { positions: Float32Array[count*3], colors: Float32Array[count*3] }
// in the mesh's WORLD frame. Colors come from vertex colors if present,
// else the material's texture map (UV-interpolated), else material/flat color.
export function sampleMesh(mesh, count) {
  const geo = mesh.geometry;
  if (!geo || !geo.isBufferGeometry) {
    throw new Error("mesh has no BufferGeometry");
  }
  mesh.updateWorldMatrix(true, false);
  const pos = geo.attributes.position;
  const uv = geo.attributes.uv;
  const vcol = geo.attributes.color;
  const nFaces = (geo.index ? geo.index.count : pos.count) / 3;

  // Cumulative area table for weighted face selection.
  const a = new THREE.Vector3(), b = new THREE.Vector3(),
        c = new THREE.Vector3();
  const cum = new Float64Array(nFaces);
  let total = 0;
  for (let f = 0; f < nFaces; f++) {
    a.fromBufferAttribute(pos, vertexIndex(geo, f, 0));
    b.fromBufferAttribute(pos, vertexIndex(geo, f, 1));
    c.fromBufferAttribute(pos, vertexIndex(geo, f, 2));
    total += triArea(a, b, c);
    cum[f] = total;
  }
  const pickFace = () => {
    const r = Math.random() * total;
    let lo = 0, hi = nFaces - 1;
    while (lo < hi) {
      const mid = (lo + hi) >> 1;
      if (cum[mid] < r) lo = mid + 1; else hi = mid;
    }
    return lo;
  };

  const material = Array.isArray(mesh.material) ? mesh.material[0]
                                                : mesh.material;
  const tex = material && material.map && material.map.image
    ? new TextureReader(material.map) : null;
  const flat = material && material.color
    ? [material.color.r, material.color.g, material.color.b]
    : [0.7, 0.7, 0.7];

  const positions = new Float32Array(count * 3);
  const colors = new Float32Array(count * 3);
  const p = new THREE.Vector3();
  for (let i = 0; i < count; i++) {
    const f = pickFace();
    const [wa, wb, wc] = randomBarycentric();
    const ia = vertexIndex(geo, f, 0), ib = vertexIndex(geo, f, 1),
          ic = vertexIndex(geo, f, 2);
    a.fromBufferAttribute(pos, ia);
    b.fromBufferAttribute(pos, ib);
    c.fromBufferAttribute(pos, ic);
    p.set(
      wa * a.x + wb * b.x + wc * c.x,
      wa * a.y + wb * b.y + wc * c.y,
      wa * a.z + wb * b.z + wc * c.z,
    );
    p.applyMatrix4(mesh.matrixWorld);
    positions.set([p.x, p.y, p.z], 3 * i);

    let col = flat;
    if (vcol) {
      col = [
        wa * vcol.getX(ia) + wb * vcol.getX(ib) + wc * vcol.getX(ic),
        wa * vcol.getY(ia) + wb * vcol.getY(ib) + wc * vcol.getY(ic),
        wa * vcol.getZ(ia) + wb * vcol.getZ(ib) + wc * vcol.getZ(ic),
      ];
    } else if (tex && uv) {
      const u = wa * uv.getX(ia) + wb * uv.getX(ib) + wc * uv.getX(ic);
      const v = wa * uv.getY(ia) + wb * uv.getY(ib) + wc * uv.getY(ic);
      col = tex.at(u, v);
    }
    colors.set(col, 3 * i);
  }
  return { positions, colors };
}

// Sample `count` points from an object hierarchy (e.g. a loaded GLTF scene),
// splitting the budget across meshes proportional to their surface area.
export function sampleObject(root, count) {
  const meshes = [];
  root.traverse((o) => { if (o.isMesh) meshes.push(o); });
  if (!meshes.length) throw new Error("no meshes in object");
  // Area per mesh for budget split.
  const areas = meshes.map((m) => {
    const geo = m.geometry;
    const pos = geo.attributes.position;
    const nF = (geo.index ? geo.index.count : pos.count) / 3;
    const a = new THREE.Vector3(), b = new THREE.Vector3(),
          c = new THREE.Vector3();
    let s = 0;
    for (let f = 0; f < nF; f++) {
      a.fromBufferAttribute(pos, vertexIndex(geo, f, 0));
      b.fromBufferAttribute(pos, vertexIndex(geo, f, 1));
      c.fromBufferAttribute(pos, vertexIndex(geo, f, 2));
      s += triArea(a, b, c);
    }
    return s;
  });
  const total = areas.reduce((x, y) => x + y, 0);
  const positions = new Float32Array(count * 3);
  const colors = new Float32Array(count * 3);
  let off = 0;
  meshes.forEach((m, i) => {
    let n = i === meshes.length - 1
      ? count - off
      : Math.round((areas[i] / total) * count);
    n = Math.min(n, count - off);
    if (n <= 0) return;
    const s = sampleMesh(m, n);
    positions.set(s.positions, 3 * off);
    colors.set(s.colors, 3 * off);
    off += n;
  });
  return { positions, colors };
}
