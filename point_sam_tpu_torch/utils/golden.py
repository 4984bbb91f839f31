"""Numpy golden oracles of the reference's module semantics (the port's
own copy of point_sam_tpu/utils/golden.py, numpy and scipy only).

Each function consumes a slice of a REFERENCE torch state dict (numpy
arrays keyed by the reference's module paths, as in the released
``model.safetensors``) and computes the reference forward for that module
in plain fp32 numpy. The parity CLI (``python -m
point_sam_tpu_torch.utils.convert --check <ckpt> --golden``) diffs them
against the port's modules running the loaded weights, module by module:
a wrong split, LN placement or attention-downsample bug shows up as a
large diff with a module's name attached.

Reference semantics: PointNet patch encoder common.py:477-506; EVA block
as timm instantiates it for eva02 / eva-giant (pc_encoder.py:138-139);
two-way transformer transformer.py:15-236.
"""

from __future__ import annotations

import numpy as np

try:  # exact erf GELU, matching torch nn.GELU
    from scipy.special import erf as _erf
except ImportError:  # pragma: no cover
    import math

    _erf = np.vectorize(math.erf, otypes=[np.float64])


def _f32(x):
    return np.asarray(x, np.float32)


def linear(x, w, b=None):
    """torch Linear: weight [out, in]."""
    y = x @ _f32(w).T
    if b is not None:
        y = y + _f32(b)
    return y


def layernorm(x, w, b, eps=1e-5):
    mu = x.mean(-1, keepdims=True)
    var = ((x - mu) ** 2).mean(-1, keepdims=True)
    return (x - mu) / np.sqrt(var + eps) * _f32(w) + _f32(b)


def gelu(x):
    return (x * 0.5 * (1.0 + _erf(x / np.sqrt(2.0)))).astype(x.dtype)


def silu(x):
    return x / (1.0 + np.exp(-x))


def softmax(x, axis=-1):
    m = x.max(axis=axis, keepdims=True)
    e = np.exp(x - m)
    return e / e.sum(axis=axis, keepdims=True)


def sub(sd: dict, prefix: str) -> dict:
    """Slice a state dict by dotted prefix."""
    p = prefix + "."
    return {k[len(p):]: v for k, v in sd.items() if k.startswith(p)}


def pointnet(sd: dict, x: np.ndarray) -> np.ndarray:
    """Patch-encoder PointNet on [..., K, C_in] (common.py:499-506)."""

    def seq(d, x):
        x = linear(x, d["0.weight"], d["0.bias"])
        x = layernorm(x, d["1.weight"], d["1.bias"])
        x = gelu(x)
        return linear(x, d["3.weight"], d["3.bias"])

    x = seq(sub(sd, "conv1"), _f32(x))
    g = x.max(axis=-2, keepdims=True)
    x = np.concatenate([np.broadcast_to(g, x.shape), x], axis=-1)
    x = seq(sub(sd, "conv2"), x)
    return x.max(axis=-2)


def _mha(q, k, v, heads):
    b, nq, c = q.shape
    hd = c // heads

    def split(t):
        return t.reshape(b, -1, heads, hd).transpose(0, 2, 1, 3)

    q, k, v = split(q), split(k), split(v)
    a = softmax((q @ k.transpose(0, 1, 3, 2)) / np.sqrt(hd))
    o = a @ v
    return o.transpose(0, 2, 1, 3).reshape(b, nq, c)


def eva_block(sd: dict, x: np.ndarray, heads: int) -> np.ndarray:
    """One EVA block, auto-detecting the sep-qkv (EVA02) vs fused-qkv
    (EVA-giant) attention and SwiGLU(+sub-LN) vs plain-GELU MLP from the
    keys present."""
    x = _f32(x)
    h = layernorm(x, sd["norm1.weight"], sd["norm1.bias"])
    a = sub(sd, "attn")
    if "qkv.weight" in a:
        d = x.shape[-1]
        w = _f32(a["qkv.weight"])
        bias = np.concatenate([
            _f32(a["q_bias"]), np.zeros(d, np.float32), _f32(a["v_bias"])])
        qkv = linear(h, w, bias)
        q, k, v = np.split(qkv, 3, axis=-1)
    else:
        q = linear(h, a["q_proj.weight"], a["q_proj.bias"])
        k = linear(h, a["k_proj.weight"])
        v = linear(h, a["v_proj.weight"], a["v_proj.bias"])
    o = _mha(q, k, v, heads)
    if "norm.weight" in a:  # timm "scale_attn_inner" sub-LN
        o = layernorm(o, a["norm.weight"], a["norm.bias"])
    x = x + linear(o, a["proj.weight"], a["proj.bias"])

    h = layernorm(x, sd["norm2.weight"], sd["norm2.bias"])
    m = sub(sd, "mlp")
    if "fc1_g.weight" in m:
        g = linear(h, m["fc1_g.weight"], m["fc1_g.bias"])
        u = linear(h, m["fc1_x.weight"], m["fc1_x.bias"])
        h = silu(g) * u
        if "norm.weight" in m:
            h = layernorm(h, m["norm.weight"], m["norm.bias"])
    else:
        h = gelu(linear(h, m["fc1.weight"], m["fc1.bias"]))
    return x + linear(h, m["fc2.weight"], m["fc2.bias"])


def _decoder_attn(sd: dict, q, k, v, heads):
    """Decoder attention with internal downsampling (transformer.py:179-236);
    the downsample rate is implicit in the projection shapes."""
    q = linear(q, sd["q_proj.weight"], sd["q_proj.bias"])
    k = linear(k, sd["k_proj.weight"], sd["k_proj.bias"])
    v = linear(v, sd["v_proj.weight"], sd["v_proj.bias"])
    o = _mha(q, k, v, heads)
    return linear(o, sd["out_proj.weight"], sd["out_proj.bias"])


def two_way_transformer(sd: dict, pc: np.ndarray, pc_pe: np.ndarray,
                        tokens: np.ndarray, heads: int = 8):
    """TwoWayTransformer forward (transformer.py:61-176)."""
    pc, pc_pe, tokens = _f32(pc), _f32(pc_pe), _f32(tokens)
    queries, keys = tokens, pc
    depth = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("layers."))
    for i in range(depth):
        d = sub(sd, f"layers.{i}")
        if i == 0:
            queries = _decoder_attn(sub(d, "self_attn"), queries, queries,
                                    queries, heads)
        else:
            q = queries + tokens
            queries = queries + _decoder_attn(sub(d, "self_attn"), q, q,
                                              queries, heads)
        queries = layernorm(queries, d["norm1.weight"], d["norm1.bias"])
        q = queries + tokens
        k = keys + pc_pe
        queries = queries + _decoder_attn(
            sub(d, "cross_attn_token_to_image"), q, k, keys, heads)
        queries = layernorm(queries, d["norm2.weight"], d["norm2.bias"])
        h = np.maximum(linear(queries, d["mlp.lin1.weight"],
                              d["mlp.lin1.bias"]), 0.0)
        queries = queries + linear(h, d["mlp.lin2.weight"], d["mlp.lin2.bias"])
        queries = layernorm(queries, d["norm3.weight"], d["norm3.bias"])
        q = queries + tokens
        k = keys + pc_pe
        keys = keys + _decoder_attn(sub(d, "cross_attn_image_to_token"),
                                    k, q, queries, heads)
        keys = layernorm(keys, d["norm4.weight"], d["norm4.bias"])
    q = queries + tokens
    k = keys + pc_pe
    queries = queries + _decoder_attn(sub(sd, "final_attn_token_to_image"),
                                      q, k, keys, heads)
    queries = layernorm(queries, sd["norm_final_attn.weight"],
                        sd["norm_final_attn.bias"])
    return queries, keys
