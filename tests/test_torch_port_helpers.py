"""The port's helpers against the JAX package and their plain versions, on
the CPU.

- ``utils/native.py``: the g++-built library against its numpy plain
  versions and against the port's ``ops.fps`` / exact ``ops.knn`` (FPS
  3000 -> 64 indices equal; kNN sets equal, d^2 within 1e-4); a build that
  fails raises with the compiler's output.
- ``utils/seeding.py``: two seeded constructions give equal weights;
  ``worker_rng`` equals JAX's draw for draw.
- ``utils/profiling.py``: ``StageTimer``'s summary and report against
  JAX's; ``trace`` writes a Chrome trace holding an ``annotate`` range.
- ``datasets/preprocess.py`` and ``datasets/build.py::FlatMaskDataset``
  against JAX's on files and a synthetic dataset the tests write.

Torch runs on one intra-op thread here (a module fixture).
"""

import json
import random
import struct

import h5py
import numpy as np
import pytest
import torch

from point_sam_tpu.datasets import build as JB
from point_sam_tpu.datasets import preprocess as JP
from point_sam_tpu.datasets.synthetic import SyntheticDataset as JSynthetic
from point_sam_tpu.utils import profiling as JPROF
from point_sam_tpu.utils import seeding as JSEED
from point_sam_tpu_torch import ops
from point_sam_tpu_torch.datasets import FlatMaskDataset, SyntheticDataset
from point_sam_tpu_torch.datasets import preprocess as P
from point_sam_tpu_torch.models import PropagateNN
from point_sam_tpu_torch.utils import native, profiling, seeding


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the ops are small, and the test files run in
    parallel processes that already hold every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -------------------------------------------------------------------- native


class TestNative:
    def test_fps_matches_plain_and_port(self, rng):
        pts = rng.standard_normal((3000, 3)).astype(np.float32)
        got = native.fps_cpu(pts, 64)
        np.testing.assert_array_equal(got, native.fps_plain(pts, 64))
        np.testing.assert_array_equal(got, ops.fps(torch.from_numpy(pts[None]), 64)[0].numpy())

    def test_knn_matches_plain_and_port(self, rng):
        q = rng.standard_normal((50, 3)).astype(np.float32)
        k = rng.standard_normal((500, 3)).astype(np.float32)
        d2, idx = native.knn_cpu(q, k, 8)
        pd2, pidx = native.knn_plain(q, k, 8)
        td2, tidx = ops.knn(torch.from_numpy(q[None]), torch.from_numpy(k[None]), 8,
                            method="exact")
        for want_d2, want_idx in ((pd2, pidx), (td2[0].numpy(), tidx[0].numpy())):
            np.testing.assert_allclose(d2, want_d2, atol=1e-4)
            for i in range(len(q)):  # sets agree (ties may reorder)
                assert set(idx[i]) == set(want_idx[i])

    def test_chamfer_matches_plain(self, rng):
        s = rng.standard_normal((200, 3)).astype(np.float32)
        t = rng.standard_normal((300, 3)).astype(np.float32)
        np.testing.assert_allclose(native.chamfer_cpu(s, t), native.chamfer_plain(s, t),
                                   atol=1e-4)

    def test_normalize_matches_plain(self, rng):
        pts = rng.standard_normal((1000, 3)).astype(np.float32) * 5 + 2
        out, shift, scale = native.normalize_cpu(pts)
        pout, pshift, pscale = native.normalize_plain(pts)
        np.testing.assert_allclose(out, pout, atol=1e-5)
        np.testing.assert_allclose(shift, pshift, atol=1e-4)
        assert scale == pytest.approx(pscale, rel=1e-5)
        np.testing.assert_allclose(out * scale + shift, pts, atol=1e-3)

    def test_bad_arguments_raise(self, rng):
        pts = rng.standard_normal((10, 3)).astype(np.float32)
        with pytest.raises(ValueError, match="num_samples"):
            native.fps_cpu(pts, 11)
        with pytest.raises(ValueError, match="k=11"):
            native.knn_cpu(pts, pts, 11)
        with pytest.raises(ValueError, match=r"\[n, 3\]"):
            native.chamfer_cpu(pts[:, :2], pts)

    @pytest.mark.parametrize("fault", ["source", "compiler"])
    def test_failed_build_raises(self, fault, tmp_path, monkeypatch):
        bad = tmp_path / "bad.cpp"
        bad.write_text("int psam_version( { return 1; }\n")
        monkeypatch.setattr(native, "SRC", bad)
        monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
        if fault == "compiler":
            monkeypatch.setenv("PATH", str(tmp_path))
        native.library.cache_clear()
        try:
            msg = "g\\+\\+ failed" if fault == "source" else "g\\+\\+ did not run"
            with pytest.raises(RuntimeError, match=msg) as err:
                native.fps_cpu(np.zeros((4, 3), np.float32), 2)
            if fault == "source":
                assert "bad.cpp" in str(err.value)  # the compiler's own output
            assert not list((tmp_path / "build").glob("*/*.so"))
        finally:
            native.library.cache_clear()


# ------------------------------------------------------------------- seeding


def test_seed_everything_repeats():
    draws = []
    for _ in range(2):
        g = seeding.seed_everything(7)
        mod = PropagateNN(16, 8, generator=g)
        draws.append((mod.state_dict(), random.random(), np.random.random(), torch.rand(3)))
    (sd1, r1, n1, t1), (sd2, r2, n2, t2) = draws
    assert all(torch.equal(sd1[k], sd2[k]) for k in sd1)
    assert (r1, n1) == (r2, n2) and torch.equal(t1, t2)
    JSEED.seed_everything(7)  # python's and numpy's global draws are JAX's
    assert (random.random(), np.random.random()) == (r1, n1)


def test_worker_rng_matches_jax():
    for seed, worker in ((0, 0), (3, 1), (2**40 + 5, 7)):
        a, b = seeding.worker_rng(seed, worker), JSEED.worker_rng(seed, worker)
        np.testing.assert_array_equal(a.random(16), b.random(16))
        np.testing.assert_array_equal(a.integers(0, 1000, 16), b.integers(0, 1000, 16))


# ----------------------------------------------------------------- profiling


def test_stage_timer_matches_jax_format():
    timer = profiling.StageTimer()
    for name in ("encode", "decode", "encode"):
        with timer.stage(name, sync_on={"x": [torch.ones(2)]}):
            torch.ones(4).sum()
    s = timer.summary()
    assert list(s) == ["decode", "encode"]
    assert [s[k]["count"] for k in s] == [1, 2]
    assert all(set(v) == {"total_s", "mean_ms", "count"} for v in s.values())
    want = JPROF.StageTimer()
    want.totals.update(timer.totals)
    want.counts.update(timer.counts)
    assert s == want.summary()
    assert timer.report() == want.report()


def test_trace_writes_chrome_trace(tmp_path):
    with profiling.trace(tmp_path):
        with profiling.annotate("psam-stage"):
            torch.ones(64).cumsum(0)
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "psam-stage" for e in events)


# ------------------------------------------------------- datasets, preprocess


def test_read_scanobjectnn_bin_matches_jax(rng, tmp_path):
    n = 40
    rec = rng.standard_normal((n, 11)).astype("<f4")
    rec[:, 9] = rng.integers(0, 4, n)  # instance ids
    path = tmp_path / "obj.bin"
    path.write_bytes(struct.pack("<i", n) + rec.tobytes())
    got, want = P.read_scanobjectnn_bin(path), JP.read_scanobjectnn_bin(path)
    assert set(got) == set(want) == {"coords", "features", "gt_masks"}
    for k in got:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    assert got["gt_masks"].shape == (len(np.unique(rec[:, 9])), n)


def test_flat_mask_dataset_matches_jax(tmp_path):
    ds, jds = SyntheticDataset(num_scenes=3, points_per_scene=256), JSynthetic(
        num_scenes=3, points_per_scene=256)
    mapping = P.build_val_mapping(ds, out_path=tmp_path / "map.npy")
    np.testing.assert_array_equal(mapping, JP.build_val_mapping(jds))
    np.testing.assert_array_equal(np.load(tmp_path / "map.npy"), mapping)
    flat, jflat = FlatMaskDataset(ds), JB.FlatMaskDataset(jds)
    assert len(flat) == len(jflat) == len(mapping)
    for i in range(len(flat)):
        got, want = flat[i], jflat.get(i)
        assert got["gt_masks"].shape == (1, 256)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    sub = FlatMaskDataset(ds, mapping[::2])
    np.testing.assert_array_equal(sub[1]["gt_masks"], flat[2]["gt_masks"])


@pytest.mark.parametrize("layout", ["label", "gt_mask"])
def test_partnet_h5_to_masks_matches_jax(layout, rng, tmp_path):
    pts = rng.standard_normal((2, 50, 3)).astype(np.float32)
    path = tmp_path / "ins_seg.h5"
    with h5py.File(path, "w") as f:
        f["pts"] = pts
        if layout == "label":
            lab = rng.integers(-1, 3, (2, 50))
            lab[1] = np.where(lab[1] == 2, 0, lab[1])  # scene 1 has no instance 2
            f["label"] = lab
        else:
            f["rgb"] = rng.uniform(0, 255, (2, 50, 3)).astype(np.float32)
            f["gt_mask"] = rng.random((2, 4, 50)) < 0.1
    got = P.partnet_h5_to_masks(str(path), str(tmp_path / "port.npz"), min_points=2)
    want = JP.partnet_h5_to_masks(str(path), str(tmp_path / "jax.npz"), min_points=2)
    assert got["num_scenes"] == want["num_scenes"] == 2
    for g, w in zip(got["scenes"], want["scenes"]):
        for k in ("coords", "features", "gt_masks"):
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])
        assert (g["gt_masks"].sum(1) >= 2).all()
    a, b = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])


def test_sample_mesh_surface_matches_jax(tmp_path):
    try:
        import trimesh
    except ImportError:
        with pytest.raises(ImportError) as got:
            P.sample_mesh_surface(str(tmp_path / "m.obj"), 10)
        with pytest.raises(ImportError) as want:
            JP.sample_mesh_surface(str(tmp_path / "m.obj"), 10)
        assert str(got.value) == str(want.value)
        return
    path = tmp_path / "box.obj"
    trimesh.creation.box().export(path)
    got, want = P.sample_mesh_surface(str(path), 64), JP.sample_mesh_surface(str(path), 64)
    np.testing.assert_array_equal(got[0], want[0])
