"""K9's bins from the centres alone (``fps.knn_bins_plain``) against the fold
that the selection loop made at every step, bit for bit.

The Pallas kernel (``point_sam_tpu/ops/fps_pallas.py::_fps_interp_knn_kernel``)
folds, at the step that selects centre g, that centre's distance field,
+inf at invalid points, into 8 * l_lanes bins: per bin the smallest
distance, ties to the smallest point id. The fold reads nothing of the
running state, so the port computes the bins after the selection, from
the centres (``knn_bins_kernel`` on the card). These tests hold that
identity on the CPU against two forms of the per-step fold:

- ``step_fold``: the port's earlier plain version, one centre's field at a
  time, reduced by torch's min and first argmax;
- ``min_tree_fold``: the Pallas kernel's own pairwise min-tree over the
  bin's lane chunks (ties keep the left operand), in numpy.

The cases: l_lanes 128 and 512; a cloud whose length is not a multiple of
4096 (the padded tail leaves cell row 7 all invalid); duplicated points
inside bins (exact ties); invalid points; bins all of whose points are
invalid. The whole K9 plain version is held to the Pallas kernel in
tests/test_torch_port_k9_k11.py, and the kernel to ``knn_bins_plain`` in
tests/test_torch_port_kernels.py (card).
"""

import importlib

import numpy as np
import pytest
import torch

F = importlib.import_module("point_sam_tpu_torch.ops.fps")

SUBLANES = 8


def bins_case(case, l_lanes):
    """(padded points [B, n_pad, 3], validity [B, n_pad], N, G)."""
    rng = np.random.default_rng(0)
    B, N, G = 1, 28_000, 100
    if case == "invalid":
        B = 2
    elif case == "ragged":  # at l_lanes 512, 3672 padded points: all of row 7
        N = 25_000
    pts = rng.standard_normal((B, N, 3)).astype(np.float32)
    valid = np.ones((B, N), bool)
    if case == "ties":  # copies one and three bin strides on: equal members
        pts[:, l_lanes:2 * l_lanes] = pts[:, :l_lanes]
        pts[:, 3 * l_lanes:4 * l_lanes] = pts[:, :l_lanes]
        pts = np.round(pts * 4) / 4  # and a coarse grid: ties across bins too
    elif case == "invalid":
        valid = rng.random((B, N)) > 0.3
        valid[:, 20_000:] = False
    elif case == "empty-bins":  # bins (2, 0..15) and (5, 40..63) lose every point
        n_pad = -(-N // (SUBLANES * l_lanes)) * SUBLANES * l_lanes
        n = np.arange(N)
        row, lane = n // (n_pad // SUBLANES), (n % (n_pad // SUBLANES)) % l_lanes
        valid[:, ((row == 2) & (lane < 16)) | ((row == 5) & (lane >= 40) & (lane < 64))] = False
    pts_p, v = F._knn_cells(torch.from_numpy(pts), torch.from_numpy(valid), l_lanes)
    return pts_p, v, N, G


def step_fold(pts, v, centers, l_lanes):
    """The bins as the port's earlier ``fps_interp_knn_plain`` folded them,
    one step at a time: the field of centre g (``fps_sq_dist``), +inf at
    invalid points, the minimum over each bin's members and the first of
    its minima."""
    B, n_pad, _ = pts.shape
    n8 = n_pad // SUBLANES
    chunks = n8 // l_lanes
    row = torch.arange(SUBLANES)[:, None]
    lane = torch.arange(l_lanes)
    cds, cis = [], []
    for g in range(centers.shape[1]):
        d = F.fps_sq_dist(pts, centers[:, g])
        dm = d.masked_fill(~v, float("inf")).view(B, SUBLANES, chunks, l_lanes)
        mn = dm.min(dim=2).values
        j = (dm == mn[:, :, None]).to(torch.uint8).argmax(dim=2)
        cds.append(mn.reshape(B, -1))
        cis.append((row * n8 + j * l_lanes + lane).reshape(B, -1).int())
    return torch.stack(cds, 1), torch.stack(cis, 1)


def min_tree_fold(pts, v, centers, l_lanes):
    """The Pallas kernel's fold in numpy: the masked field d + (0 or +inf)
    cut into lane chunks [8, l_lanes], reduced pairwise (lt = right <
    left, ties keep the left chunk) down to one."""
    B, n_pad, _ = pts.shape
    n8 = n_pad // SUBLANES
    chunks = n8 // l_lanes
    pm = np.where(v.numpy(), 0.0, np.inf).astype(np.float32)
    lane = np.arange(l_lanes, dtype=np.int32)
    row = np.arange(SUBLANES, dtype=np.int32)[:, None]
    cds, cis = [], []
    for g in range(centers.shape[1]):
        dm = (F.fps_sq_dist(pts, centers[:, g]).numpy() + pm).reshape(B, SUBLANES, n8)
        ds = [dm[..., i * l_lanes:(i + 1) * l_lanes] for i in range(chunks)]
        cs = [np.broadcast_to(lane + i * l_lanes, ds[0].shape) for i in range(chunks)]
        while len(ds) > 1:
            nd, nc = [], []
            for j in range(0, len(ds) - 1, 2):
                lt = ds[j + 1] < ds[j]
                nd.append(np.where(lt, ds[j + 1], ds[j]))
                nc.append(np.where(lt, cs[j + 1], cs[j]))
            if len(ds) % 2:
                nd.append(ds[-1])
                nc.append(cs[-1])
            ds, cs = nd, nc
        cds.append(ds[0].reshape(B, -1))
        cis.append((row * n8 + cs[0]).reshape(B, -1))
    return np.stack(cds, 1), np.stack(cis, 1).astype(np.int32)


CASES = ["ragged", "ties", "invalid", "empty-bins"]


@pytest.mark.parametrize("l_lanes", [128, 512])
@pytest.mark.parametrize("case", CASES)
def test_bins_from_centres_equal_the_step_fold(case, l_lanes):
    pts, v, _, G = bins_case(case, l_lanes)
    _, centers, _, _ = F.fps_interp_plain(pts, G, valid=v)
    cd, ci = F.knn_bins_plain(pts, v, centers, l_lanes)
    want_d, want_i = step_fold(pts, v, centers, l_lanes)
    assert cd.shape == ci.shape == (pts.shape[0], G, SUBLANES * l_lanes)
    assert cd.dtype == torch.float32 and ci.dtype == torch.int32
    assert torch.equal(cd.view(torch.int32), want_d.view(torch.int32))
    assert torch.equal(ci, want_i)


@pytest.mark.parametrize("l_lanes", [128, 512])
@pytest.mark.parametrize("case", CASES)
def test_bins_from_centres_equal_the_pallas_min_tree(case, l_lanes):
    pts, v, N, G = bins_case(case, l_lanes)
    _, centers, _, _ = F.fps_interp_plain(pts, G, valid=v)
    cd, ci = F.knn_bins_plain(pts, v, centers, l_lanes)
    want_d, want_i = min_tree_fold(pts, v, centers, l_lanes)
    np.testing.assert_array_equal(cd.numpy().view(np.int32), want_d.view(np.int32))
    np.testing.assert_array_equal(ci.numpy(), want_i)
    n8 = pts.shape[1] // SUBLANES
    if case == "ragged" and l_lanes == 512:  # row 7 all padding: +inf, member 0
        assert N <= 7 * n8
        assert torch.isinf(cd[..., 7 * l_lanes:]).all()
        np.testing.assert_array_equal(ci[0, 0, 7 * l_lanes:].numpy(),
                                      7 * n8 + np.arange(l_lanes))
    if case == "empty-bins":
        for r, lanes in ((2, range(0, 16)), (5, range(40, 64))):
            got = ci[..., [r * l_lanes + l for l in lanes]]
            assert torch.isinf(cd[..., [r * l_lanes + l for l in lanes]]).all()
            assert torch.equal(got, (r * n8 + torch.tensor(list(lanes))).int().expand_as(got))


def test_bins_of_any_centres_are_their_fields_minima():
    """The bins depend on the centres alone: centres that FPS would not
    pick (here random points, some invalid) give each bin's minimum of
    their own distance fields, and a centre tile boundary changes no bit."""
    pts, v, _, _ = bins_case("invalid", 128)
    rng = np.random.default_rng(3)
    centers = pts[:, rng.integers(0, pts.shape[1], 130)]
    cd, ci = F.knn_bins_plain(pts, v, centers, 128)
    want_d, want_i = step_fold(pts, v, centers, 128)
    assert torch.equal(cd.view(torch.int32), want_d.view(torch.int32))
    assert torch.equal(ci, want_i)


def test_knn_bins_cuda_refuses_cpu_tensors_and_bad_lanes():
    pts, v, _, _ = bins_case("ragged", 128)
    centers = pts[:, :8]
    with pytest.raises(ValueError, match="CUDA"):
        F.knn_bins_cuda(pts, v, centers, 128)
    with pytest.raises(ValueError, match="multiple of 32"):
        F.knn_bins_cuda(pts, v, centers, 48)
