"""The yardstick's arithmetic: the card's peaks, each hand-written kernel's
bytes and operations at a launch shape, and the models' FLOPs.

Frozen with the benchmark. The peaks are NVIDIA's H100 SXM data sheet
figures at 700 W (dense, no sparsity): 989 TFLOP/s in bf16 on the tensor
cores, 67 TFLOP/s in fp32 outside them, 3.35 TB/s of HBM. A kernel's least
time is the larger of its bytes over the memory rate and its operations
over the peak of their type (``bound``); each input byte counts once and
each output byte once, and the operations are those the launch's inputs
need. The per-kernel counts are copied from the program's on-card smoke
script (``chip_smoke.py``: ``bound``, ``pe_work`` and the counts of its
``kernel_case``).

A kernel *family* groups the counted wrappers of the program
(``module:function``, whose ``shapes`` record every launch by its sizes)
with the name fragments of the CUDA kernels they launch, so a trace's
kernel time and the counters' launches meet by family.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}
MFU_PEAK = PEAK_FLOPS["bf16"]


def bound(nbytes: float, ops: dict) -> tuple[float, str]:
    """(least seconds for the work, what bounds it): bytes over the memory
    rate against the operations over the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = sum(n / PEAK_FLOPS[kind] for kind, n in ops.items())
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def pe_work(rows, groups, cin, h0, h1, cout, elem, argmax=False):
    """(bytes, FLOPs) of one patch-encoder forward (K2) over ``rows``
    grouped points; with ``argmax`` it also writes pool, arg2 and arg4."""
    w = cin * h0 + h0 * h0 + 2 * h0 * h1 + h1 * cout
    flops = 2 * rows * (cin * h0 + h0 * h0 + h0 * h1 + h1 * cout) + 2 * groups * h0 * h1
    saved = argmax * groups * (h0 * elem + 4 * (h0 + cout))
    return rows * cin * elem + w * elem + groups * cout * elem + saved, flops


def _dtype(s: str) -> tuple[int, str]:
    """(bytes an element, peak kind) of a launch key's dtype string."""
    return (2, "bf16") if "bfloat16" in s else (4, "fp32")


def kernel_work(family: str, key: dict, n_real: int | None = None):
    """(bytes, {kind: operations}) of one launch of ``family`` at the
    launch key its wrapper recorded, or None where the key alone cannot
    say what the inputs need (K7's rows depend on the max-pools' argmaxes).
    ``n_real``: the real points of a padded cloud (the farthest-point loop
    computes only those)."""
    if family in ("K1", "K8"):
        B, N, G, valid = key["B"], key["N"], key["G"], key["valid"]
        n = n_real if (valid and n_real) else N
        nbytes = B * (N * (12 + valid) + G * (16 if family == "K1" else 4)
                      + (N * 24 if family == "K1" else 0))
        return nbytes, {"fp32": 10.0 * B * n * G}
    if family == "K10":
        B, N, G = key["B"], key["N"], key["G"]
        return B * (N * 12 + G * 12 + N * 24), {"fp32": 14.0 * B * N * G}
    if family == "K12":
        B, nq, nk, k, valid = key["B"], key["Nq"], key["Nk"], key["k"], key["valid"]
        return B * (nq * 12 + nk * (12 + valid) + nq * k * 8), {"fp32": 8.0 * B * nq * nk}
    if family == "K2":
        elem, kind = _dtype(key["cdt"])
        B, G, K = key["B"], key["G"], key["K"]
        nbytes, flops = pe_work(B * G * K, B * G, key["cin"], key["h0"], key["h1"], key["cout"],
                                elem, key["argmax"])
        return nbytes, {kind: flops}
    if family == "attention":
        elem, kind = _dtype(key["dtype"])
        if "dh" in key:  # heads split [B, H, S, dh] (K5)
            B, S, D = key["B"], key["S"], key["heads"] * key["dh"]
        else:  # packed [B, S, D] (K3)
            B, S, D = key["B"], key["S"], key["D"]
        return 4 * B * S * D * elem, {kind: 4.0 * B * S * S * D}
    if family == "K6":
        elem, kind = _dtype(key["dtype"])
        B, S, D = key["B"], key["S"], key["D"]
        return 7 * B * S * D * elem, {kind: 10.0 * B * S * S * D}
    if family == "tail":
        elem, kind = _dtype(key["cdt"])
        D, C, N = key["D"], key["C"], key["N"]
        if "BM" in key:  # rows given (K11)
            BM = key["BM"]
            nbytes = BM * N * D * elem + D * D * elem + BM * C * D * elem + BM * C * N * 4
        else:  # 3-NN interpolation fused in (K4)
            B, BM, G = key["B"], key["B"] * key["M"], key["G"]
            nbytes = (BM * G * D * elem + B * N * 3 * 8 + D * D * elem + BM * C * D * elem
                      + BM * C * N * 4)
        return nbytes, {kind: 2.0 * BM * N * D * D + 2.0 * BM * C * N * D}
    return None


# family -> (kernel name fragments, the wrappers that launch them)
FAMILIES = {
    "K1": (("fps_interp_kernel<1>", "fps_cluster_kernel<true", "nn3_kernel<false"),
           ("point_sam_tpu_torch.ops.fps:fps_interp_cuda",)),
    "K8": (("fps_interp_kernel<0>", "fps_cluster_kernel<false"),
           ("point_sam_tpu_torch.ops.fps:fps_cuda",)),
    "K9": (("knn_bins_kernel",), ("point_sam_tpu_torch.ops.fps:fps_interp_knn_cuda",)),
    "K10": (("nn3_kernel<true",), ("point_sam_tpu_torch.ops.interp_pallas:interp_weights_cuda",)),
    "K12": (("knn_select_kernel",), ("point_sam_tpu_torch.ops.knn:knn_select_cuda",)),
    "K2": (("patch_encoder_kernel", "patch_encoder_mma_kernel"),
           ("point_sam_tpu_torch.ops.patch_encoder_pallas:patch_encoder_cuda",)),
    "K7": (("patch_encoder_bwd", "reduce_slices_kernel"),
           ("point_sam_tpu_torch.ops.patch_encoder_pallas:patch_encoder_bwd_cuda",)),
    "attention": (("mha_kernel",), ("point_sam_tpu_torch.ops.attention:mha_cuda",
                                    "point_sam_tpu_torch.ops.attention:mha_heads_cuda")),
    "K6": (("attn_bwd_",), ("point_sam_tpu_torch.ops.attention:mha_packed_bwd_cuda",)),
    "tail": (("interp_upscale",), ("point_sam_tpu_torch.ops.upscale_pallas:interp_upscale_cuda",
                                   "point_sam_tpu_torch.ops.upscale_pallas:upscale_hyper_cuda")),
}


def family_of(kernel_name: str) -> str | None:
    for fam, (frags, _) in FAMILIES.items():
        if any(f in kernel_name for f in frags):
            return fam
    return None


# ------------------------------------------------------------------ models
def vit_flops(vit: dict, B: int, S: int) -> float:
    """The ViT's products over B clouds of S tokens: projections, the two
    attention products, the MLP."""
    D, H = vit["embed_dim"], vit["mlp_hidden_dim"]
    per_block = 2 * S * D * 3 * D + 4 * S * S * D + 2 * S * D * D
    per_block += (3 if vit["swiglu"] else 2) * 2 * S * D * H
    return float(B * vit["depth"] * per_block)


def encode_flops(cfg: dict, kind, B: int, n_points: int, G: int, K: int | None = None) -> float:
    """One encode of B clouds of ``n_points`` points into G tokens: the
    kind's patch embed (``kind.embed_flops``), the projection into the ViT,
    the centres' positional MLP, the ViT, the projection out and the
    centres' Fourier encoding."""
    vit, D, out = cfg["vit"], cfg["vit"]["embed_dim"], cfg["embed_dim"]
    pc = cfg["patch_embed_channels"]
    embed = kind.embed_flops(cfg, B, n_points, G, K)
    proj = 2 * B * G * (pc * D + 3 * 128 + 128 * D + D * out + 3 * (out // 2))
    return float(embed + proj) + vit_flops(vit, B, G)


def decode_flops(cfg: dict, kind, R: int, P: int, G: int, N: int, C: int, with_mask: bool,
                 K: int | None = None) -> float:
    """One decode of R rows (B clouds times M prompts) with P click slots:
    the click encoding, the kind's mask prompt encoder (when there is one,
    ``kind.mask_prompt_flops``), the two-way transformer, the upscaling onto
    N points by the 3-NN weights, the hypernetworks and the IoU head; C
    masks a row."""
    D, mlp, depth = cfg["embed_dim"], cfg["decoder"]["mlp_dim"], cfg["decoder"]["depth"]
    Dh = D // 2
    T = 1 + (cfg["num_multimask_outputs"] + 1) + P
    f = 2 * R * P * 3 * (D // 2)
    if with_mask:
        f += kind.mask_prompt_flops(cfg, R, N, G, K)

    def attn(nq, nk, width):  # q from nq tokens, k / v from nk, out back to D
        return (2 * R * nq * D * width + 2 * 2 * R * nk * D * width + 4 * R * nq * nk * width
                + 2 * R * nq * width * D)

    for _ in range(depth):
        f += attn(T, T, D) + attn(T, G, Dh) + 2 * 2 * R * T * D * mlp + attn(G, T, Dh)
    f += attn(T, G, Dh)
    f += 2 * R * G * D * D  # the upscaling's first Dense, on the tokens
    f += C * 3 * 2 * R * D * D  # the hypernetworks
    f += 2 * R * N * 3 * D + 2 * R * N * D * D + 2 * R * C * N * D  # the tail
    f += 2 * R * (D * 256 + 256 * 256 + 256 * (cfg["num_multimask_outputs"] + 1))
    return float(f)
