// Annotator logic: viewer + click-to-segment loop.
// Own implementation of the reference demo's viewer.js/annotate.js behavior
// (raycast a click onto the nearest point, POST /segment, alpha-blend the
// returned mask, accumulate instances with /next, persist with /save).

import * as THREE from "three";
import { OrbitControls } from "three/addons/controls/OrbitControls.js";
import { GLTFLoader } from "three/addons/loaders/GLTFLoader.js";
import { OBJLoader } from "three/addons/loaders/OBJLoader.js";
import { sampleObject } from "./mesh_sample.js";

const scene = new THREE.Scene();
const camera = new THREE.PerspectiveCamera(
  55, window.innerWidth / window.innerHeight, 0.01, 100);
camera.position.set(0, 0.6, 2.2);
const renderer = new THREE.WebGLRenderer({ antialias: true });
renderer.setSize(window.innerWidth, window.innerHeight);
document.body.appendChild(renderer.domElement);
const controls = new OrbitControls(camera, renderer.domElement);
controls.enableDamping = true;

let points = null;        // THREE.Points
let baseColors = null;    // Float32Array [N*3]
let positions = null;     // Float32Array [N*3]
let mask = null;          // bool[]
let promptPts = [];       // [{idx, label}]
let label = 1;
const instanceHues = [0xff5252, 0x52a8ff, 0x6aff52, 0xffd152, 0xd052ff];
let instanceMasks = [];

const MASK_COLOR = [0.25, 0.95, 0.55];
const POS_COLOR = [0.2, 1.0, 0.2];
const NEG_COLOR = [1.0, 0.2, 0.2];

const status = (m) => document.getElementById("status").textContent = m;

function setCloud(xyz, rgb) {
  if (points) scene.remove(points);
  const n = xyz.length / 3;
  positions = new Float32Array(xyz);
  baseColors = new Float32Array(rgb);
  const geo = new THREE.BufferGeometry();
  geo.setAttribute("position", new THREE.BufferAttribute(positions, 3));
  geo.setAttribute("color",
    new THREE.BufferAttribute(baseColors.slice(), 3));
  const mat = new THREE.PointsMaterial({ size: 0.012, vertexColors: true });
  points = new THREE.Points(geo, mat);
  scene.add(points);
  mask = null; promptPts = []; instanceMasks = [];
  status(`${n} points loaded`);
}

function repaint() {
  if (!points) return;
  const colors = points.geometry.getAttribute("color");
  const n = colors.count;
  for (let i = 0; i < n; i++) {
    let r = baseColors[3 * i], g = baseColors[3 * i + 1],
        b = baseColors[3 * i + 2];
    for (let m = 0; m < instanceMasks.length; m++) {
      if (instanceMasks[m][i]) {
        const c = new THREE.Color(instanceHues[m % instanceHues.length]);
        r = 0.35 * r + 0.65 * c.r; g = 0.35 * g + 0.65 * c.g;
        b = 0.35 * b + 0.65 * c.b;
      }
    }
    if (mask && mask[i]) {
      r = 0.35 * r + 0.65 * MASK_COLOR[0];
      g = 0.35 * g + 0.65 * MASK_COLOR[1];
      b = 0.35 * b + 0.65 * MASK_COLOR[2];
    }
    colors.setXYZ(i, r, g, b);
  }
  for (const p of promptPts) {
    const c = p.label ? POS_COLOR : NEG_COLOR;
    colors.setXYZ(p.idx, c[0], c[1], c[2]);
  }
  colors.needsUpdate = true;
}

async function post(path, body) {
  const r = await fetch(path, { method: "POST", body: JSON.stringify(body) });
  if (!r.ok) throw new Error(`${path}: ${r.status} ${await r.text()}`);
  return r.json();
}

async function loadCloud() {
  const name = document.getElementById("plyname").value;
  status("loading " + name + " (encoder runs server-side)...");
  const r = await fetch(`/pointcloud/${name}`);
  if (!r.ok) { status(`load failed: ${r.status}`); return; }
  const d = await r.json();
  setCloud(d.xyz, d.rgb);
}

const ray = new THREE.Raycaster();
ray.params.Points.threshold = 0.02;
renderer.domElement.addEventListener("pointerdown", async (ev) => {
  if (!points || ev.button !== 0 || ev.shiftKey) return;
  const ndc = new THREE.Vector2(
    (ev.clientX / window.innerWidth) * 2 - 1,
    -(ev.clientY / window.innerHeight) * 2 + 1);
  ray.setFromCamera(ndc, camera);
  const hits = ray.intersectObject(points);
  if (!hits.length) return;
  const idx = hits[0].index;
  const p = [positions[3 * idx], positions[3 * idx + 1],
             positions[3 * idx + 2]];
  promptPts.push({ idx, label });
  status("segmenting...");
  try {
    const d = await post("/segment", { prompt_point: p, prompt_label: label });
    mask = d.seg;
    status(`mask: ${mask.filter(Boolean).length} points`);
    repaint();
  } catch (e) { status(String(e)); }
});

// ---- Mesh files: load GLTF/GLB/OBJ locally, sample points in-browser, and
// feed them to the encoder via POST /sampled_pointcloud (the route the
// reference demo serves for browser-sampled meshes, demo/app.py:91-107).
async function loadMeshFile(file) {
  const url = URL.createObjectURL(file);
  const ext = file.name.split(".").pop().toLowerCase();
  try {
    let root;
    if (ext === "gltf" || ext === "glb") {
      const gltf = await new GLTFLoader().loadAsync(url);
      root = gltf.scene;
    } else if (ext === "obj") {
      root = await new OBJLoader().loadAsync(url);
    } else {
      status(`unsupported mesh format .${ext} (use gltf/glb/obj)`);
      return;
    }
    const count = parseInt(document.getElementById("nsamples").value) || 30000;
    status(`sampling ${count} surface points...`);
    const { positions, colors } = sampleObject(root, count);
    // Normalize into the unit sphere (the model's input frame).
    const n = positions.length / 3;
    const mean = [0, 0, 0];
    for (let i = 0; i < n; i++)
      for (let d = 0; d < 3; d++) mean[d] += positions[3 * i + d] / n;
    let scale = 0;
    for (let i = 0; i < n; i++) {
      let s = 0;
      for (let d = 0; d < 3; d++) {
        positions[3 * i + d] -= mean[d];
        s += positions[3 * i + d] ** 2;
      }
      scale = Math.max(scale, Math.sqrt(s));
    }
    for (let i = 0; i < 3 * n; i++) positions[i] /= scale || 1;
    status("encoding (server-side)...");
    await post("/sampled_pointcloud", {
      points: Object.fromEntries(positions.entries()),
      colors: Object.fromEntries(colors.entries()),
    });
    setCloud(Array.from(positions), Array.from(colors));
    status(`${n} points sampled from ${file.name}`);
  } catch (e) {
    status(String(e));
  } finally {
    URL.revokeObjectURL(url);
  }
}

document.getElementById("meshfile").addEventListener("change", (ev) => {
  if (ev.target.files.length) loadMeshFile(ev.target.files[0]);
});

document.getElementById("load").onclick = loadCloud;
document.getElementById("pos").onclick = () => {
  label = 1;
  document.getElementById("pos").classList.add("active");
  document.getElementById("neg").classList.remove("active");
};
document.getElementById("neg").onclick = () => {
  label = 0;
  document.getElementById("neg").classList.add("active");
  document.getElementById("pos").classList.remove("active");
};
document.getElementById("clear").onclick = async () => {
  await post("/clear", {});
  mask = null; promptPts = [];
  repaint(); status("cleared");
};
document.getElementById("next").onclick = async () => {
  const d = await post("/next", {});
  if (mask) instanceMasks.push(mask);
  mask = null; promptPts = [];
  repaint(); status(`instances: ${d.num_instances}`);
};
document.getElementById("save").onclick = async () => {
  const d = await post("/save", {});
  instanceMasks = []; mask = null; promptPts = [];
  repaint(); status(`saved -> ${d.path}`);
};

window.addEventListener("resize", () => {
  camera.aspect = window.innerWidth / window.innerHeight;
  camera.updateProjectionMatrix();
  renderer.setSize(window.innerWidth, window.innerHeight);
});

(function animate() {
  requestAnimationFrame(animate);
  controls.update();
  renderer.render(scene, camera);
})();
