"""MViTv2 in plain float32, following PySlowFast's ``MViT`` (Li et al.,
arXiv:2112.01526; the ``MViT`` class and ``attention.py`` of
``slowfast/models``) under ``MViTv2_S_16x4.yaml`` line by line: ``PatchEmbed``
(a Conv3d with a bias), ``MultiScaleBlock``s with ``dim_mul_in_att`` (the
width and heads doubling inside the attention at the transition blocks),
``MultiScaleAttention`` in ``mode="conv"`` (``attention_pool``: the
per-head depthwise Conv3d and its LayerNorm for q, k and v), the scores
``(q·scale)·kᵀ`` materialised (B, h, Nq, Nk), ``cal_rel_pos_spatial`` and
``cal_rel_pos_temporal`` (the query-dependent einsums with the unscaled
pooled q), the softmax, ``attn·v + q`` (residual pooling), the projection,
the skip path (``proj`` of the normed input at a transition, then the
``pool_skip`` MaxPool3d), drop path on both branches, then the head: the
final LayerNorm, the mean over tokens, dropout and ``projection``.

Departures from PySlowFast, each also the port's: the tables of an axis
have 2·max(Lq, Lk) − 1 rows for the pooled sizes Lq and Lk (PySlowFast's
input size over each stride, equal at the published sizes, where the
strides divide the grid); the Linear weights and tables start N(0, 0.02)
(``trunc_normal_(std=.02)`` without the truncation) and the convolutions
Xavier-uniform; drop-path rates are d·i/(depth − 1) in double precision
(PySlowFast's float32 ``linspace``).  ``masks`` serves the keep masks
(``train.Masks``) in the port's order: for each block the attention
branch's drop path, then the MLP branch's, each a (B, 1, 1) mask at the
block's rate (none at rate 0), then the head's dropout; with ``masks``
None nothing is dropped.  ``q`` rounds the operands of every product.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

EPS = 1e-6


def _plan(cfg: dict) -> list[dict]:
    """PySlowFast's per-block schedule: widths, heads, strides, grids."""
    thw = [(d + 2 * p - k) // s + 1 for d, k, s, p in zip(
        cfg["img_size"], cfg["patch_kernel"], cfg["patch_stride"], cfg["patch_padding"])]
    dim, heads, kv = cfg["embed_dim"], cfg["num_heads"], list(cfg["pool_kv_stride_adaptive"])
    depth, out = cfg["depth"], []
    for i in range(depth):
        mul = i in cfg["dim_mul_blocks"]
        stride_q = list(cfg["pool_q_stride"]) if mul else [1, 1, 1]
        kv = [max(k // s, 1) for k, s in zip(kv, stride_q)]
        dim_out, heads = (dim * 2, heads * 2) if mul else (dim, heads)
        q_dims = [(d + 2 - 3) // s + 1 for d, s in zip(thw, stride_q)]
        k_dims = [(d + 2 - 3) // s + 1 for d, s in zip(thw, kv)]
        out.append({"dim": dim, "dim_out": dim_out, "heads": heads, "stride_q": stride_q,
                    "stride_kv": list(kv), "thw": list(thw), "q": q_dims, "k": k_dims,
                    "drop_path": cfg["drop_path_rate"] * i / (depth - 1) if depth > 1 else 0.0})
        dim, thw = dim_out, q_dims
    return out


def shapes(cfg: dict) -> dict:
    """PySlowFast's names in the port's order of registration."""
    E, M = cfg["embed_dim"], cfg["num_modalities"] * cfg["in_channels"]
    out = {"patch_embed.proj.weight": (E, M, *cfg["patch_kernel"]), "patch_embed.proj.bias": (E,)}
    for i, p in enumerate(_plan(cfg)):
        b, D, C = f"blocks.{i}", p["dim_out"] // p["heads"], p["dim_out"]
        out.update({f"{b}.norm1.weight": (p["dim"],), f"{b}.norm1.bias": (p["dim"],),
                    f"{b}.attn.rel_pos_h": (2 * max(p["q"][1], p["k"][1]) - 1, D),
                    f"{b}.attn.rel_pos_w": (2 * max(p["q"][2], p["k"][2]) - 1, D),
                    f"{b}.attn.rel_pos_t": (2 * max(p["q"][0], p["k"][0]) - 1, D),
                    f"{b}.attn.qkv.weight": (3 * C, p["dim"]), f"{b}.attn.qkv.bias": (3 * C,),
                    f"{b}.attn.proj.weight": (C, C), f"{b}.attn.proj.bias": (C,)})
        for n in "qkv":
            out.update({f"{b}.attn.pool_{n}.weight": (D, 1, 3, 3, 3),
                        f"{b}.attn.norm_{n}.weight": (D,), f"{b}.attn.norm_{n}.bias": (D,)})
        hidden = int(C * cfg["mlp_ratio"])
        out.update({f"{b}.norm2.weight": (C,), f"{b}.norm2.bias": (C,),
                    f"{b}.mlp.fc1.weight": (hidden, C), f"{b}.mlp.fc1.bias": (hidden,),
                    f"{b}.mlp.fc2.weight": (C, hidden), f"{b}.mlp.fc2.bias": (C,)})
        if p["dim"] != C:
            out.update({f"{b}.proj.weight": (C, p["dim"]), f"{b}.proj.bias": (C,)})
    C = _plan(cfg)[-1]["dim_out"]
    out.update({"norm.weight": (C,), "norm.bias": (C,),
                "head.projection.weight": (cfg["num_classes"], C),
                "head.projection.bias": (cfg["num_classes"],)})
    return out


def weight_kind(name: str, shape) -> str:
    """The stem and the pools Xavier-uniform over the convolution's fans;
    the tables and Linear weights N(0, 0.02); LayerNorm weights one; biases
    zero."""
    if len(shape) == 5:
        return "xavier"
    if len(shape) == 2:
        return "normal"
    return "ones" if name.endswith(".weight") else "zeros"


# --- PySlowFast's helpers ----------------------------------------------------------

def attention_pool(tensor, w, stride, thw, norm_w, norm_b, q):
    """``attention_pool`` with ``mode="conv"``: (B, h, L, D) → pooled and normed."""
    B, N, L, C = tensor.shape
    T, H, W = thw
    tensor = tensor.reshape(B * N, T, H, W, C).permute(0, 4, 1, 2, 3).contiguous()
    tensor = F.conv3d(q(tensor), q(w), None, stride, 1, 1, C)
    thw = [tensor.shape[2], tensor.shape[3], tensor.shape[4]]
    L_pooled = tensor.shape[2] * tensor.shape[3] * tensor.shape[4]
    tensor = tensor.reshape(B, N, C, L_pooled).transpose(2, 3)
    return F.layer_norm(tensor, (C,), norm_w, norm_b, EPS), thw


def _dist(lq: int, lk: int) -> torch.Tensor:
    q_ratio, k_ratio = max(lk / lq, 1.0), max(lq / lk, 1.0)
    dist = torch.arange(lq)[:, None] * q_ratio - torch.arange(lk)[None, :] * k_ratio
    return (dist + (lk - 1) * k_ratio).long()


def cal_rel_pos_spatial(attn, qq, q_shape, k_shape, rel_pos_h, rel_pos_w, q):
    q_t, q_h, q_w = q_shape
    k_t, k_h, k_w = k_shape
    Rh = rel_pos_h[_dist(q_h, k_h).to(attn.device)]
    Rw = rel_pos_w[_dist(q_w, k_w).to(attn.device)]
    B, n_head, q_N, dim = qq.shape
    r_q = qq.reshape(B, n_head, q_t, q_h, q_w, dim)
    rel_h = torch.einsum("byhwc,hkc->byhwk", q(r_q.flatten(1, 2)), q(Rh)).view(
        B, n_head, q_t, q_h, q_w, k_h)
    rel_w = torch.einsum("byhwc,wkc->byhwk", q(r_q.flatten(1, 2)), q(Rw)).view(
        B, n_head, q_t, q_h, q_w, k_w)
    attn = (attn.view(B, n_head, q_t, q_h, q_w, k_t, k_h, k_w)
            + rel_h[:, :, :, :, :, None, :, None] + rel_w[:, :, :, :, :, None, None, :])
    return attn.view(B, n_head, q_t * q_h * q_w, k_t * k_h * k_w)


def cal_rel_pos_temporal(attn, qq, q_shape, k_shape, rel_pos_t, q):
    q_t, q_h, q_w = q_shape
    k_t, k_h, k_w = k_shape
    Rt = rel_pos_t[_dist(q_t, k_t).to(attn.device)]
    B, n_head, q_N, dim = qq.shape
    r_q = qq.reshape(B, n_head, q_t, q_h, q_w, dim)
    r_q = r_q.permute(2, 0, 1, 3, 4, 5).reshape(q_t, B * n_head * q_h * q_w, dim)
    rel = torch.matmul(q(r_q), q(Rt).transpose(1, 2)).transpose(0, 1)
    rel = rel.view(B, n_head, q_h, q_w, q_t, k_t).permute(0, 1, 4, 2, 3, 5)
    attn = (attn.view(B, n_head, q_t, q_h, q_w, k_t, k_h, k_w)
            + rel[:, :, :, :, :, :, None, None])
    return attn.view(B, n_head, q_t * q_h * q_w, k_t * k_h * k_w)


def _drop_path(x, rate: float, masks):
    """Drop path on (B, N, C): a (B, 1, 1) keep mask drawn through ``masks``
    at keep 1 − rate (its rate for this call), kept rows scaled by 1/keep."""
    if masks is None or rate == 0.0:
        return x
    keep = masks.keep
    masks.keep = 1.0 - rate
    try:
        m = masks(torch.ones((x.shape[0], 1, 1), device=x.device))
    finally:
        masks.keep = keep
    return torch.where(m != 0, x / (1.0 - rate), torch.zeros((), device=x.device))


# --- the forward ------------------------------------------------------------------

class _Net:
    def __init__(self, w: dict, cfg: dict, masks, q):
        self.w, self.cfg, self.masks, self.q = w, cfg, masks, q

    def lin(self, x, name):
        return self.q(x) @ self.q(self.w[f"{name}.weight"]).t() + self.w[f"{name}.bias"]

    def norm(self, x, name):
        return F.layer_norm(x, (x.shape[-1],), self.w[f"{name}.weight"],
                            self.w[f"{name}.bias"], EPS)

    def attention(self, x, p, b, thw):
        """``MultiScaleAttention.forward`` on (B, N, C_in)."""
        B, N, _ = x.shape
        w, q, heads = self.w, self.q, p["heads"]
        qkv = self.lin(x, f"{b}.qkv").reshape(B, N, 3, heads, -1).permute(2, 0, 3, 1, 4)
        qq, k, v = qkv[0], qkv[1], qkv[2]
        pools = {}
        for name, t, stride in (("q", qq, p["stride_q"]), ("k", k, p["stride_kv"]),
                                ("v", v, p["stride_kv"])):
            pools[name] = attention_pool(t, w[f"{b}.pool_{name}.weight"], stride, thw,
                                         w[f"{b}.norm_{name}.weight"],
                                         w[f"{b}.norm_{name}.bias"], q)
        (qq, q_shape), (k, k_shape), (v, _) = pools["q"], pools["k"], pools["v"]
        scale = qq.shape[-1] ** -0.5
        attn = q(qq * scale) @ q(k).transpose(-2, -1)
        attn = cal_rel_pos_spatial(attn, qq, q_shape, k_shape, w[f"{b}.rel_pos_h"],
                                   w[f"{b}.rel_pos_w"], q)
        attn = cal_rel_pos_temporal(attn, qq, q_shape, k_shape, w[f"{b}.rel_pos_t"], q)
        attn = attn.softmax(dim=-1)
        x = q(attn) @ q(v) + qq
        x = x.transpose(1, 2).reshape(B, -1, p["dim_out"])
        return self.lin(x, f"{b}.proj"), q_shape

    def block(self, x, p, b, thw):
        """``MultiScaleBlock.forward`` (``dim_mul_in_att``)."""
        x_norm = self.norm(x, f"{b}.norm1")
        x_block, thw_new = self.attention(x_norm, p, f"{b}.attn", thw)
        if p["dim"] != p["dim_out"]:
            x = self.lin(x_norm, f"{b}.proj")
        if p["stride_q"][1] > 1 or p["stride_q"][2] > 1 or p["stride_q"][0] > 1:
            kernel = [s + 1 if s > 1 else s for s in p["stride_q"]]
            B, _, C = x.shape
            t = x.reshape(B, *thw, C).permute(0, 4, 1, 2, 3)
            t = F.max_pool3d(t, kernel, p["stride_q"], [k // 2 for k in kernel])
            x = t.reshape(B, C, -1).transpose(1, 2)
        x = x + _drop_path(x_block, p["drop_path"], self.masks)
        x_mlp = self.lin(F.gelu(self.lin(self.norm(x, f"{b}.norm2"), f"{b}.mlp.fc1")),
                         f"{b}.mlp.fc2")
        return x + _drop_path(x_mlp, p["drop_path"], self.masks), thw_new

    def forward(self, img):
        B, M, C = img.shape[:3]
        x = img.reshape(B, M * C, *img.shape[3:])
        x = F.conv3d(self.q(x), self.q(self.w["patch_embed.proj.weight"]),
                     self.w["patch_embed.proj.bias"], self.cfg["patch_stride"],
                     self.cfg["patch_padding"])
        thw = list(x.shape[2:])
        x = x.flatten(2).transpose(1, 2)
        for i, p in enumerate(_plan(self.cfg)):
            x, thw = self.block(x, p, f"blocks.{i}", thw)
        x = self.norm(x, "norm").mean(1)
        if self.masks is not None:
            x = self.masks(x)
        return self.lin(x, "head.projection")


def logits(w, cfg, img, masks, q):
    return _Net(w, cfg, masks, q).forward(img)
