"""The demo HTTP server of the port against the JAX package's, on the CPU
in fp32: the same tiny kNN model (ViT "tiny", G=32, K=8; JAX's initial
weights plus N(0, 0.05) noise on every bias and LayerNorm scale, through
``state_dict_from_flax``) behind both servers, the same asset directory
and the same requests over real HTTP on 127.0.0.1.

Checks: the route and JSON contract answer alike (``GET /pointcloud``,
``POST /sampled_pointcloud``, ``/segment``, ``/clear``, ``/next``,
``/save``); every ``seg`` list is equal; the saved instances are equal;
the static files are served byte-equal; a path that leaves the static
directory is refused with 403; a click with no cloud loaded is a clean
500 with a message.
"""

import http.client
import json
import threading
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from point_sam_tpu import models as J
from point_sam_tpu.serving import server as JS

from point_sam_tpu_torch import models as P
from point_sam_tpu_torch.datasets.synthetic import generate_scene
from point_sam_tpu_torch.serving import server as TS
from point_sam_tpu_torch.utils import state_dict_from_flax
from point_sam_tpu_torch.utils.ply import save_ply


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module (see test_torch_port_eval.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    jm = J.PointCloudSAM(J.PointSAMConfig(vit="tiny", tokenizer=J.TokenizerConfig(32, 8),
                                          prompt_iters=3))
    rng = np.random.default_rng(0)

    def leaf(path, a):
        a = np.array(a, np.float32)
        if a.ndim != 1 and path[-1].key not in ("bias", "scale"):
            return a
        return a + 0.05 * rng.standard_normal(a.shape).astype(np.float32)

    v = jax.tree_util.tree_map_with_path(
        leaf, jax.tree_util.tree_map(np.asarray, J.init_variables(jm, jax.random.PRNGKey(0))))
    pm = P.PointCloudSAM(P.PointSAMConfig(vit="tiny", tokenizer=P.TokenizerConfig(32, 8)))
    pm.load_state_dict(state_dict_from_flax(v), strict=True)
    return jm, v, pm


def serve(httpd):
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return f"http://127.0.0.1:{httpd.server_address[1]}", thread


@pytest.fixture(scope="module")
def servers(models, tmp_path_factory):
    """(JAX server's URL, port server's URL, their output directories)
    over one asset directory holding a 1200-point scene."""
    jm, v, pm = models
    root = tmp_path_factory.mktemp("serve")
    ex = generate_scene(4, num_points=1200)
    save_ply(root / "obj.ply", ex["coords"], np.clip(ex["features"], 0, 255).astype(np.uint8))
    jax_httpd, _ = JS.build_server(jm, v, port=0, model_dir=root, output_dir=root / "jax")
    port_httpd, _ = TS.build_server(pm, device="cpu", port=0, model_dir=root,
                                    output_dir=root / "port")
    (jax_url, jt), (port_url, pt) = serve(jax_httpd), serve(port_httpd)
    yield jax_url, port_url, root
    for httpd, thread in ((jax_httpd, jt), (port_httpd, pt)):
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
        assert not thread.is_alive()


def post(url, path, payload):
    req = urllib.request.Request(url + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def get(url, path):
    with urllib.request.urlopen(url + path, timeout=120) as r:
        return r.read()


def both(servers, fn, *args):
    jax_url, port_url, _ = servers
    return fn(jax_url, *args), fn(port_url, *args)


def test_click_workflow_matches_jax(servers):
    """Load the asset, three clicks (positive, negative, positive; the
    later two with the previous best logits as mask prompt), the next
    instance, one more click, then save: the same answers from both."""
    want, got = both(servers, get, "/pointcloud/obj.ply")
    cloud = json.loads(got)
    assert cloud == json.loads(want)
    n = len(cloud["xyz"]) // 3
    assert n == 1200 and len(cloud["rgb"]) == 3 * n and max(cloud["rgb"]) <= 1.0
    xyz = np.asarray(cloud["xyz"]).reshape(-1, 3)
    segs = []
    for i, label in ((10, 1), (700, 0), (500, 1)):
        want, got = both(servers, post, "/segment",
                         {"prompt_point": xyz[i].tolist(), "prompt_label": label})
        assert len(got["seg"]) == n
        assert got == want
        segs.append(np.asarray(got["seg"]))
    assert any(s.any() and not s.all() for s in segs)  # the check has teeth
    want, got = both(servers, post, "/next", {})
    assert got == want == {"status": "cleared", "num_instances": 1}
    want, got = both(servers, post, "/segment", {"prompt_point": xyz[300].tolist(),
                                                 "prompt_label": 1})
    assert got == want
    want, got = both(servers, post, "/next", {})
    assert got == want == {"status": "cleared", "num_instances": 2}
    want, got = both(servers, post, "/save", {})
    assert got["status"] == want["status"] == "saved"
    assert Path(got["path"]).name == Path(want["path"]).name == "obj.npy"
    saved = [np.load(r["path"], allow_pickle=True).item() for r in (want, got)]
    assert saved[1]["mask"].shape == (2, n)
    for k in ("xyz", "rgb", "mask"):
        np.testing.assert_array_equal(saved[1][k], saved[0][k], err_msg=k)
    np.testing.assert_array_equal(saved[1]["mask"][0], segs[-1])
    want, got = both(servers, post, "/clear", {})
    assert got == want == {"status": "cleared"}


def test_sampled_pointcloud_matches_jax(servers, rng):
    """The browser-sampled path: index-keyed points and colours, as
    static/mesh_sample.js posts them, then a click."""
    xyz = rng.standard_normal((900, 3)).astype(np.float32)
    xyz -= xyz.mean(0)
    xyz /= np.linalg.norm(xyz, axis=1).max()
    rgb = rng.random((900, 3)).astype(np.float32)
    payload = {"points": {str(i): float(x) for i, x in enumerate(xyz.ravel())},
               "colors": {str(i): float(x) for i, x in enumerate(rgb.ravel())}}
    want, got = both(servers, post, "/sampled_pointcloud", payload)
    assert got == want == {"response": "success"}
    for label in (1, 0):
        want, got = both(servers, post, "/segment", {"prompt_point": xyz[label].tolist(),
                                                     "prompt_label": 1 - label})
        assert len(got["seg"]) == 900 and got == want


@pytest.mark.parametrize("path", ["/", "/index.html", "/annotate.js", "/mesh_sample.js"])
def test_static_files_match_jax(servers, path):
    want, got = both(servers, get, path)
    assert got == want and len(got) > 1000
    name = "index.html" if path == "/" else path[1:]
    assert got == (Path(TS.__file__).parent / "static" / name).read_bytes()


@pytest.mark.parametrize("path", ["/../server.py", "/js/../../predictor.py", "/nothing.js"])
def test_static_refusals_match_jax(servers, path):
    """A path out of the static directory: 403 from both; a missing file:
    404."""
    codes = []
    for url in servers[:2]:
        conn = http.client.HTTPConnection(url.removeprefix("http://"), timeout=60)
        try:
            conn.request("GET", path)
            resp = conn.getresponse()
            codes.append((resp.status, json.loads(resp.read())))
        finally:
            conn.close()
    assert codes[1] == codes[0]
    assert codes[1][0] == (404 if path == "/nothing.js" else 403)


def test_segment_without_cloud_is_clean_error(models, tmp_path):
    """A click before any cloud: 500 and a message, from a fresh server of
    each package."""
    jm, v, pm = models
    for httpd in (JS.build_server(jm, v, port=0, model_dir=tmp_path, output_dir=tmp_path)[0],
                  TS.build_server(pm, device="cpu", port=0, model_dir=tmp_path,
                                  output_dir=tmp_path)[0]):
        url, thread = serve(httpd)
        try:
            with pytest.raises(urllib.error.HTTPError) as err:
                post(url, "/segment", {"prompt_point": [0, 0, 0], "prompt_label": 1})
            assert err.value.code == 500
            assert "no point cloud" in json.loads(err.value.read())["error"]
        finally:
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=10)
        assert not thread.is_alive()


def test_build_server_needs_a_card(models, monkeypatch):
    """Without a device named and without a card, no CPU fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TS.build_server(models[2], port=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TS.main(["--config", "tiny", "--port", "0"])
