"""Reference checkpoints in the port against the JAX package, on the CPU.

Inputs are the reference-format state dicts of tests/test_convert.py
(``ref_state_dict``, the timm extras), as JAX's converter tests build
theirs:

- ``load_reference_state_dict`` against JAX ``convert_state_dict`` (tiny
  EVA02; the fused-qkv EVA-giant shape; a fused qkv split onto EVA02;
  timm extras with ``fc_norm``; ``attn.norm`` with and without
  ``attn_inner_norm``; ``q_norm`` / ``gamma_1``; missing keys): the
  ``unmapped``, ``recognized_unused`` and ``variant_unsupported`` lists
  equal, ``unfilled`` equal through ``torch_key_for``, ``strict`` raising
  in the same cases, and the tiny model's masks and IoUs over the loaded
  weights within 1e-5 of JAX's over its converted ones;
- the ``attn_inner_norm`` EvaBlock against JAX's, 1e-5;
- ``utils/safetensors_io.py`` against the ``safetensors`` package, both
  ways, bit for bit, for each dtype;
- ``load_weights`` against JAX ``load_variables`` on one file (the same
  warning lines, the same outputs), and on a ``torch.save`` file and a
  trainer checkpoint directory;
- ``convert_uni3d`` against JAX's;
- the port's golden oracles bit-equal to JAX's;
- ``checkpoint_check(..., golden=True, device="cpu")`` at ``--config
  tiny`` against JAX's, and a corrupted weight failing the port's CLI.

JAX builds its models with unrolled ViT blocks (``scan_blocks=False``), so
each of its leaves has one torch key. Torch runs on one intra-op thread.
"""

import re

import numpy as np
import pytest
import torch

import jax

import chip_smoke
import tests.test_convert as TC
from point_sam_tpu import models as J
from point_sam_tpu.utils import checkpoint as JCK
from point_sam_tpu.utils import convert as JC
from point_sam_tpu.utils import golden as JG

from point_sam_tpu_torch import models as P
from point_sam_tpu_torch.utils import CheckpointManager, state_dict_from_flax, torch_key_for
from point_sam_tpu_torch.utils import convert as C
from point_sam_tpu_torch.utils import golden as G
from point_sam_tpu_torch.utils import safetensors_io as SIO
from point_sam_tpu_torch.utils.checkpoint import load_weights
from point_sam_tpu_torch.utils.config import build_model, load_config


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module (tiny ops; see ROADMAP.md's
    note on tier-1 time under parallel test processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TINY = dict(embed_dim=128, depth=2, num_heads=4, mlp_hidden_dim=256)
GIANT = dict(TINY, swiglu=False, qkv_fused=True)


def scaled(sd):
    """Fan-in-scaled weights (test_convert.py's ``_scaled_sd``): raw N(0, 1)
    matrices saturate the softmax and the max-pools."""
    return {k: (v / np.sqrt(v.shape[1])).astype(np.float32)
            if v.ndim == 2 and "gaussian" not in k else np.ascontiguousarray(v)
            for k, v in sd.items()}


def fuse_qkv(sd, depth=2, dim=128, seed=1):
    """timm's fused attention: qkv.weight, q_bias, v_bias in place of the
    separate projections."""
    rng = np.random.default_rng(seed)
    for i in range(depth):
        b = f"pc_encoder.transformer.blocks.{i}.attn"
        for p in ("q_proj", "k_proj", "v_proj"):
            sd.pop(f"{b}.{p}.weight", None)
            sd.pop(f"{b}.{p}.bias", None)
        sd[f"{b}.qkv.weight"] = (rng.standard_normal((3 * dim, dim)) / np.sqrt(dim)).astype(
            np.float32)
        sd[f"{b}.q_bias"] = rng.standard_normal(dim).astype(np.float32)
        sd[f"{b}.v_bias"] = rng.standard_normal(dim).astype(np.float32)
    return sd


def attn_norm(sd, depth=2, dim=128, seed=2):
    rng = np.random.default_rng(seed)
    for i in range(depth):
        b = f"pc_encoder.transformer.blocks.{i}.attn.norm"
        sd[f"{b}.weight"] = (1 + 0.2 * rng.standard_normal(dim)).astype(np.float32)
        sd[f"{b}.bias"] = (0.1 * rng.standard_normal(dim)).astype(np.float32)
    return sd


def case_sd(name):
    """(ViT fields, reference-format state dict) of a triage case."""
    if name == "tiny":
        return TINY, scaled(TC.ref_state_dict())
    if name == "giant_fused":
        return GIANT, fuse_qkv(scaled(TC.ref_state_dict(swiglu=False)))
    if name == "fused_onto_eva02":
        return TINY, fuse_qkv(scaled(TC.ref_state_dict()))
    if name == "timm_extras":
        sd = scaled(TC.ref_state_dict())
        sd.update(TC.TestConverter().timm_extras(np.random.default_rng(0), 128, 16))
        for leaf in ("weight", "bias"):
            sd[f"pc_encoder.transformer.fc_norm.{leaf}"] = sd.pop(
                f"pc_encoder.transformer.norm.{leaf}")
        sd["decoder.unknown.weight"] = np.zeros((2, 2), np.float32)
        return TINY, sd
    if name == "attn_norm_without":
        return TINY, attn_norm(scaled(TC.ref_state_dict()))
    if name == "attn_norm_with":
        return dict(TINY, attn_inner_norm=True), attn_norm(scaled(TC.ref_state_dict()))
    if name == "q_norm_gamma":
        sd = scaled(TC.ref_state_dict())
        sd["pc_encoder.transformer.blocks.0.attn.q_norm.weight"] = np.ones(128, np.float32)
        sd["pc_encoder.transformer.blocks.1.gamma_1"] = np.ones(128, np.float32)
        return TINY, sd
    if name == "missing":
        sd = scaled(TC.ref_state_dict())
        for k in ("mask_decoder.iou_token.weight", "pc_encoder.transformer.blocks.1.mlp.fc2.bias",
                  "mask_decoder.output_upscaling.1.bias"):
            sd.pop(k)
        return TINY, sd
    raise KeyError(name)


CASES = ("tiny", "giant_fused", "fused_onto_eva02", "timm_extras", "attn_norm_without",
         "attn_norm_with", "q_norm_gamma", "missing")


def jax_model(vit, prompt_iters=2):
    jv = J.ViTConfig(**{k: v for k, v in vit.items()}, scan_blocks=False,
                     mlp_norm=vit.get("swiglu", True))
    m = J.PointCloudSAM(J.PointSAMConfig(vit=jv, tokenizer=J.TokenizerConfig(16, 8),
                                         prompt_iters=prompt_iters))
    return m, jax.tree_util.tree_map(np.asarray, J.init_variables(m, jax.random.PRNGKey(0)))


def port_model(vit, variables=None):
    m = P.PointCloudSAM(P.PointSAMConfig(vit=P.ViTConfig(**vit),
                                         tokenizer=P.TokenizerConfig(16, 8), prompt_iters=2),
                        generator=torch.Generator().manual_seed(0))
    if variables is not None:
        m.load_state_dict(state_dict_from_flax(variables), strict=True)
    return m


def torch_keys(flax_paths):
    """The port's keys of JAX leaf paths: a fused bias is the port's q_bias
    and v_bias, the label table its point_embeddings rows."""
    out = set()
    for path in flax_paths:
        if path.endswith("/attn/qkv/bias"):
            base = torch_key_for(path[:-len("/bias")] + "/kernel").rsplit(".qkv.", 1)[0]
            out |= {f"{base}.q_bias", f"{base}.v_bias"}
        elif path == "params/point_encoder/label_embed":
            out |= {f"point_encoder.point_embeddings.{i}.weight" for i in (0, 1)}
        else:
            out.add(torch_key_for(path))
    return sorted(out)


def raised(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def cloud(n=256, seed=0):
    rng = np.random.default_rng(seed)
    xyz = rng.standard_normal((1, n, 3)).astype(np.float32)
    xyz /= np.abs(xyz).max() + 1e-3
    return xyz, rng.random((1, n, 3)).astype(np.float32)


def predict_both(jm, jvars, pm):
    """predict_masks of both models on one cloud and two clicks."""
    xyz, rgb = cloud()
    pc, pl = xyz[:, [3, 40]], np.array([[True, False]])
    jmask, jiou = jm.apply(jvars, xyz, rgb, pc, pl, method=jm.predict_masks)
    with torch.no_grad():
        pmask, piou = pm.predict_masks(*(torch.from_numpy(a) for a in (xyz, rgb, pc, pl)))
    return (np.asarray(jmask), np.asarray(jiou)), (pmask.numpy(), piou.numpy())


# ------------------------------------------------------------ key triage
@pytest.mark.parametrize("name", CASES)
def test_triage_matches_jax(name):
    vit, sd = case_sd(name)
    jm, jvars = jax_model(vit)
    jnew, jrep = JC.convert_state_dict(sd, jvars, strict=False)
    pm = port_model(vit, jvars)
    rep = C.load_reference_state_dict(pm, sd, strict=False)
    for field in ("unmapped", "recognized_unused", "variant_unsupported"):
        assert rep[field] == jrep[field], field
    assert rep["unfilled"] == torch_keys(jrep["unfilled"])
    # strict raises where JAX's does, with the same advice.
    jerr = raised(lambda: JC.convert_state_dict(sd, jvars, strict=True))
    perr = raised(lambda: C.load_reference_state_dict(port_model(vit), sd, strict=True))
    assert (jerr is None) == (perr is None), (jerr, perr)
    if jerr is not None:
        assert jerr.split(":")[0] == perr.split(":")[0]
        assert ("attn_inner_norm" in jerr) == ("attn_inner_norm" in perr)
    if name in ("tiny", "giant_fused", "fused_onto_eva02", "timm_extras", "attn_norm_with"):
        assert not rep["unfilled"]
        (jmask, jiou), (pmask, piou) = predict_both(jm, jnew, pm)
        np.testing.assert_allclose(pmask, jmask, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(piou, jiou, rtol=1e-5, atol=1e-5)


def test_fused_qkv_split_and_alias_values():
    """The thirds of a fused qkv land on q_proj / k_proj / v_proj, the
    biases on q_proj / v_proj, fc_norm on norm; the giant model takes the
    fused tensors as they are."""
    _, sd = case_sd("fused_onto_eva02")
    pm = port_model(TINY)
    C.load_reference_state_dict(pm, sd)
    got = pm.state_dict()
    b = "pc_encoder.transformer.blocks.1.attn"
    w = torch.from_numpy(sd[f"{b}.qkv.weight"])
    for i, p in enumerate(("q_proj", "k_proj", "v_proj")):
        assert torch.equal(got[f"{b}.{p}.weight"], w[128 * i:128 * (i + 1)])
    assert torch.equal(got[f"{b}.q_proj.bias"], torch.from_numpy(sd[f"{b}.q_bias"]))
    assert torch.equal(got[f"{b}.v_proj.bias"], torch.from_numpy(sd[f"{b}.v_bias"]))
    _, sd = case_sd("giant_fused")
    gm = port_model(GIANT)
    C.load_reference_state_dict(gm, sd)
    assert torch.equal(gm.state_dict()[f"{b}.qkv.weight"], torch.from_numpy(sd[f"{b}.qkv.weight"]))
    _, sd = case_sd("timm_extras")
    C.load_reference_state_dict(pm, sd, strict=False)
    assert torch.equal(pm.state_dict()["pc_encoder.transformer.norm.weight"],
                       torch.from_numpy(sd["pc_encoder.transformer.fc_norm.weight"]))


def test_shape_mismatch_raises_and_casts_to_the_parameter():
    _, sd = case_sd("tiny")
    pm = port_model(TINY)
    bad = dict(sd)
    bad["pc_encoder.patch_proj.weight"] = np.zeros((128, 64), np.float32)
    before = pm.state_dict()["mask_decoder.iou_token.weight"].clone()
    with pytest.raises(ValueError, match="shape mismatch for pc_encoder.patch_proj.weight"):
        C.load_reference_state_dict(pm, bad)
    # nothing was written before the check failed
    assert torch.equal(pm.state_dict()["mask_decoder.iou_token.weight"], before)
    half = {k: torch.from_numpy(v).half() for k, v in sd.items()}
    C.load_reference_state_dict(pm, half)
    p = pm.state_dict()["mask_decoder.iou_token.weight"]
    assert p.dtype == torch.float32
    assert torch.equal(p, half["mask_decoder.iou_token.weight"].float())


def test_attn_inner_norm_block_matches_jax():
    """The EvaBlock with ``attn_inner_norm`` against JAX's, 1e-5: the port's
    seeded weights (a random LN affine) carried across by JAX's own key
    rules (``map_torch_key``)."""
    from point_sam_tpu.models.vit import EvaBlock as JEvaBlock
    from point_sam_tpu_torch.models.vit import EvaBlock

    cfg = P.ViTConfig(128, 1, 2, 256, attn_inner_norm=True)
    g = torch.Generator().manual_seed(3)
    blk = EvaBlock(cfg, generator=g)
    with torch.no_grad():
        for n, p in blk.named_parameters():
            if p.dim() == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=g))
    params = {}
    prefix = "pc_encoder.transformer.blocks.0."
    for k, v in blk.state_dict().items():
        path, tr = JC.map_torch_key(prefix + k)
        node = params
        parts = path.split("/")[4:]  # below params/pc_encoder/transformer/blocks_0
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = tr(v.numpy())
    assert "norm" in params["attn"]
    x = np.random.default_rng(4).standard_normal((2, 20, 128)).astype(np.float32)
    jcfg = J.ViTConfig(128, 1, 2, 256, attn_inner_norm=True)
    want = np.asarray(JEvaBlock(jcfg).apply({"params": params}, x))
    with torch.no_grad():
        got = blk(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    plain = P.ViTConfig(128, 1, 2, 256)
    assert not any(".norm." in k and "attn" in k
                   for k in EvaBlock(plain, generator=g).state_dict())


# ------------------------------------------------------------ safetensors
DTYPES = (torch.float64, torch.float32, torch.float16, torch.bfloat16, torch.int64, torch.int32,
          torch.bool)


def sample_tensors(dtype):
    g = torch.Generator().manual_seed(7)
    out = {}
    for i, shape in enumerate(((3, 5), (7,), (), (0, 4), (2, 3, 4))):
        t = torch.randn(shape, generator=g) * 50
        if dtype == torch.bool:
            t = t > 0
        out[f"t{i}.weight"] = t.to(dtype)
    return out


def bits(t):
    return t.view(torch.int16) if t.dtype in (torch.bfloat16, torch.float16) else t


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_safetensors_io_against_the_package(dtype, tmp_path):
    from safetensors import safe_open
    from safetensors.torch import load_file, save_file

    ts = sample_tensors(dtype)
    SIO.save_file(ts, tmp_path / "ours.safetensors", metadata={"format": "pt"})
    back = load_file(str(tmp_path / "ours.safetensors"))
    with safe_open(str(tmp_path / "ours.safetensors"), framework="pt") as f:
        assert f.metadata() == {"format": "pt"}
    save_file(ts, str(tmp_path / "theirs.safetensors"), metadata={"format": "pt"})
    ours = SIO.load_file(tmp_path / "theirs.safetensors")
    for got in (back, ours):
        assert set(got) == set(ts)
        for k, t in ts.items():
            assert got[k].dtype == t.dtype and got[k].shape == t.shape, k
            assert torch.equal(bits(got[k]), bits(t)), k


def test_safetensors_io_mixed_dtypes_and_errors(tmp_path):
    from safetensors.torch import load_file

    ts = {f"{d}".split(".")[-1]: sample_tensors(d)["t0.weight"] for d in DTYPES}
    SIO.save_file(ts, tmp_path / "mix.safetensors")
    back = load_file(str(tmp_path / "mix.safetensors"))
    for k, t in ts.items():
        assert torch.equal(bits(back[k]), bits(t)), k
    with pytest.raises(ValueError, match="dtype"):
        SIO.save_file({"c": torch.zeros(2, dtype=torch.complex64)}, tmp_path / "bad.safetensors")


# ------------------------------------------------------------ load_weights
def test_load_weights_matches_load_variables(tmp_path, capsys):
    """One reference file into both packages' tiny models (the port's from
    JAX's initial weights): the same two warning lines (unfilled names
    through ``torch_key_for``) and the same masks and IoUs."""
    from safetensors.numpy import save_file

    sd = scaled(TC.ref_state_dict())
    sd.pop("mask_decoder.iou_token.weight")
    sd["extra.head.weight"] = np.zeros((3, 3), np.float32)
    path = tmp_path / "model.safetensors"
    save_file(sd, str(path))
    jm, jvars = jax_model(TINY)
    jnew = JCK.load_variables(str(path), jvars)
    want = capsys.readouterr().out.splitlines()
    pm = port_model(TINY, jvars)
    report = load_weights(path, pm)
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) == 2
    assert got[0] == want[0] == "warning: 1 unmapped torch keys (first: ['extra.head.weight'])"
    m = re.match(r"warning: (\d+) unfilled params \(first: \['(.*)'\]\)", want[1])
    assert got[1] == f"warning: {m.group(1)} unfilled params (first: " \
                     f"{torch_keys([m.group(2)])})"
    assert report["unfilled"] == ["mask_decoder.iou_token.weight"]
    (jmask, jiou), (pmask, piou) = predict_both(jm, jnew, pm)
    np.testing.assert_allclose(pmask, jmask, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(piou, jiou, rtol=1e-5, atol=1e-5)


def test_load_weights_state_dict_and_trainer_directory(tmp_path):
    src = port_model(TINY)
    with torch.no_grad():
        for p in src.parameters():
            p.add_(1.0)
    torch.save(src.state_dict(), tmp_path / "model.pt")
    dst = port_model(TINY)
    assert load_weights(tmp_path / "model.pt", dst)["unfilled"] == []
    for k, v in src.state_dict().items():
        assert torch.equal(dst.state_dict()[k], v), k
    ck = CheckpointManager(tmp_path / "run" / "checkpoints")
    ck.save(1, {"model": port_model(TINY).state_dict(), "optimizer": {}, "step": 1})
    ck.save(2, {"model": src.state_dict(), "optimizer": {}, "step": 2})
    dst = port_model(TINY)
    load_weights(tmp_path / "run" / "checkpoints", dst)
    for k, v in src.state_dict().items():
        assert torch.equal(dst.state_dict()[k], v), k
    partial = src.state_dict()
    partial.pop("mask_decoder.iou_token.weight")
    torch.save(partial, tmp_path / "partial.pt")
    with pytest.raises(RuntimeError, match="Missing key"):
        load_weights(tmp_path / "partial.pt", dst)
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        load_weights(tmp_path / "empty", dst)
    with pytest.raises(FileNotFoundError):
        load_weights(tmp_path / "nothing.pt", dst)


# ------------------------------------------------------------ Uni3D
def uni3d_module(seed=5):
    """A Uni3D checkpoint's ``module`` at the tiny widths: the encoder under
    point_encoder.{encoder2trans, pos_embed, visual}, timm extras and the
    rest of Uni3D (ignored)."""
    rng = np.random.default_rng(seed)
    module = {}
    for k, v in scaled(TC.ref_state_dict()).items():
        for src, dst in (("pc_encoder.patch_proj.", "point_encoder.encoder2trans."),
                         ("pc_encoder.pos_embed.", "point_encoder.pos_embed."),
                         ("pc_encoder.transformer.", "point_encoder.visual.")):
            if k.startswith(src):
                module[dst + k[len(src):]] = (v + 0.01 * rng.standard_normal(v.shape)).astype(
                    np.float32)
    module["point_encoder.visual.cls_token"] = np.zeros((1, 1, 128), np.float32)
    module["point_encoder.visual.weird.weight"] = np.zeros(3, np.float32)
    module["point_encoder.encoder.first_conv.weight"] = np.zeros((4, 4), np.float32)
    module["logit_scale"] = np.ones((), np.float32)
    return module


def test_convert_uni3d_matches_jax():
    module = uni3d_module()
    jm, jvars = jax_model(TINY)
    jnew, jrep = JC.convert_uni3d({"module": module}, jvars)
    pm = port_model(TINY, jvars)
    rep = C.convert_uni3d({"module": {k: torch.from_numpy(v) for k, v in module.items()}}, pm)
    for field in ("unmapped", "recognized_unused", "variant_unsupported"):
        assert rep[field] == jrep[field], field
    assert rep["unfilled"] == torch_keys(jrep["unfilled"])
    assert rep["unmapped"] == ["pc_encoder.transformer.weird.weight"]
    want = state_dict_from_flax(jnew)
    for k, v in pm.state_dict().items():
        assert torch.equal(v, want[k]), k


# ------------------------------------------------------------ parity CLI
def test_golden_oracles_bit_equal_to_jax():
    rng = np.random.default_rng(9)
    for swiglu, fused, inner in ((True, False, False), (False, True, False), (True, False, True)):
        sd = scaled(TC.ref_state_dict(swiglu=swiglu))
        if fused:
            sd = fuse_qkv(sd)
        if inner:
            sd = attn_norm(sd)
        bsd = G.sub(sd, "pc_encoder.transformer.blocks.0")
        assert bsd == JG.sub(sd, "pc_encoder.transformer.blocks.0")
        x = rng.standard_normal((2, 6, 128)).astype(np.float32)
        np.testing.assert_array_equal(G.eva_block(bsd, x, 4), JG.eva_block(bsd, x, 4))
    pn = G.sub(sd, "pc_encoder.patch_embed.patch_encoder")
    x = rng.standard_normal((2, 4, 8, 6)).astype(np.float32)
    np.testing.assert_array_equal(G.pointnet(pn, x), JG.pointnet(pn, x))
    tw = G.sub(sd, "mask_decoder.transformer")
    pc, pe, tok = (rng.standard_normal(s).astype(np.float32)
                   for s in ((2, 10, 256), (2, 10, 256), (2, 5, 256)))
    for g, j in zip(G.two_way_transformer(tw, pc, pe, tok), JG.two_way_transformer(tw, pc, pe, tok)):
        np.testing.assert_array_equal(g, j)
    for f in ("gelu", "silu", "softmax"):
        np.testing.assert_array_equal(getattr(G, f)(x), getattr(JG, f)(x))


@pytest.mark.parametrize("extra", [False, True], ids=["clean", "unknown_key"])
def test_checkpoint_check_matches_jax(extra, tmp_path, capsys):
    from safetensors.numpy import save_file

    sd = scaled(TC.ref_state_dict())
    if extra:
        sd["pc_encoder.something.weight"] = np.zeros(2, np.float32)
    path = tmp_path / "ckpt.safetensors"
    save_file(sd, str(path))
    want = JC.checkpoint_check(str(path), config="tiny", golden=True)
    got = C.checkpoint_check(path, config="tiny", golden=True, device="cpu")
    for k in ("keys", "mapped", "ok", "unmapped", "variant_unsupported"):
        assert got[k] == want[k], k
    assert got["unfilled"] == torch_keys(want["unfilled"])
    assert set(got["golden"]) == set(want["golden"])
    assert all(d < 1e-4 for d in got["golden"].values()), got["golden"]
    out = capsys.readouterr().out
    assert out.count("PARITY OK") == 2 * (not extra)
    rc = C.main(["--check", str(path), "--golden", "--config", "tiny", "--device", "cpu"])
    assert rc == (1 if extra else 0)


def test_corrupted_weight_fails_the_cli(tmp_path, monkeypatch, capsys):
    """A loader that puts a wrong value into one ViT weight makes the golden
    pass fail and the CLI exit 1; so does a golden pass that reports a large
    diff (JAX's test_golden_failure_fails_the_cli)."""
    from safetensors.numpy import save_file

    path = tmp_path / "ckpt.safetensors"
    save_file(scaled(TC.ref_state_dict()), str(path))
    args = ["--check", str(path), "--golden", "--config", "tiny", "--device", "cpu"]
    assert C.main(args) == 0
    load = C.load_reference_state_dict

    def corrupt(model, sd, **kw):
        report = load(model, sd, **kw)
        with torch.no_grad():
            model.pc_encoder.transformer.blocks[1].attn.v_proj.weight[3, 5] += 0.5
        return report

    monkeypatch.setattr(C, "load_reference_state_dict", corrupt)
    assert C.main(args) == 1
    assert "vit.block_1" in capsys.readouterr().out.split("LARGE")[0].splitlines()[-1]
    monkeypatch.setattr(C, "load_reference_state_dict", load)
    monkeypatch.setattr(C, "golden_module_diffs", lambda *a, **kw: [("vit.block_0", 0.37)])
    assert C.main(args) == 1


def test_released_format_file_through_load_model(tmp_path, capsys):
    """The chip smoke test's released-checkpoint phase at the tiny config on
    the CPU: a reference-format file written from a seeded model by that
    phase's writer (``chip_smoke.reference_state``) loads
    through the evaluator's ``load_model`` (the timm extras recognized,
    nothing unfilled), its Predictor's clicks equal the writing model's bit
    for bit, and the parity CLI passes on it."""
    import argparse

    from point_sam_tpu_torch.evalsuite import eval_interactive as TE
    from point_sam_tpu_torch.serving import Predictor

    cfg = load_config("tiny")
    src = build_model(cfg.model, generator=torch.Generator().manual_seed(11))
    path = tmp_path / "model.safetensors"
    SIO.save_file(chip_smoke.reference_state(torch, src), path, metadata={"format": "pt"})
    model, dev, rep = TE.load_model(argparse.Namespace(config="tiny", ckpt_path=str(path),
                                                       device="cpu", overrides=[]))
    assert len(rep["recognized_unused"]) == 4 and not rep["unfilled"] and not rep["unmapped"]
    xyz, rgb = (a[0] for a in cloud(1500, seed=4))
    outs = []
    for m in (src, model):
        pred = Predictor(m, device="cpu", point_buckets=(2048,))
        pred.set_pointcloud(xyz, rgb)
        outs.append([pred.click(xyz[i], i != 700) for i in (5, 700, 1200)])
    for a, b in zip(*outs):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert C.main(["--check", str(path), "--golden", "--config", "tiny", "--device", "cpu"]) == 0
    assert "PARITY OK" in capsys.readouterr().out
