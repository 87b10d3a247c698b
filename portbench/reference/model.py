"""ModelCross and ModelVIT as plain float32 PyTorch, from a dict of weights
under the reference repository's state-dict names: the code that their
families' files (``reference/families/ModelCross.py``, ``ModelVIT.py``)
call.

ModelCross (reference ``model_cross.py``): one shared patch embedding, CLS
token and positional embedding for every stream; ``num_multi_blocks``
blocks of per-stream pre-norm self-attention stacks (bias-free fused QKV,
softmax(QKᵀ/√d)V, output projection), then for each ``attn_order`` entry
i → j a CLS-query cross-attention of stream i's CLS over stream j's patch
tokens (biased wq, wk, wv, softmax, output projection, the CLS slice as the
residual) and a feed-forward on the fused CLS; per-stream LayerNorm and MLP
heads on the CLS, logits averaged over the streams, cross-entropy.
ModelVIT (reference ``modelv3.py``): every stream's patch tokens embedded
and concatenated behind one CLS token, ``num_layers`` pre-norm layers, a
LayerNorm → Linear → GELU (erf) → Linear head, cross-entropy.

Dropout (train mode, rate ``dropout``) at the reference's sites, in the
order a forward reaches them: after the positional embedding (per stream),
after each self-attention's output projection, after the feed-forward's
GELU and after its second Linear, on the cross-attention's probabilities
and after its projection, and twice in each head.  ``masks`` serves the
keep masks (``train.Masks``); the trunk's GELU is tanh when
``gelu_approx``, the ModelCross heads' too, ModelVIT's head's is erf.

``q`` rounds the operands of every product (the identity for the
reference, a lower precision for the control).  Patches are
'b c (d p1) (h p2) (w p3) -> b (h w d) (p1 p2 p3 c)'.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _ident(x: torch.Tensor) -> torch.Tensor:
    return x


def patchify(vol: torch.Tensor, patch) -> torch.Tensor:
    """(B, C, D, H, W) → (B, (H/p2)(W/p3)(D/p1), p1·p2·p3·C)."""
    p1, p2, p3 = patch
    B, C, D, H, W = vol.shape
    x = vol.reshape(B, C, D // p1, p1, H // p2, p2, W // p3, p3)
    x = x.permute(0, 4, 6, 2, 3, 5, 7, 1)
    return x.reshape(B, (H // p2) * (W // p3) * (D // p1), p1 * p2 * p3 * C)


class Net:
    """One forward of one block of rows through a model's weights."""

    def __init__(self, w: dict, cfg: dict, masks, q=_ident):
        self.w, self.cfg, self.masks, self.q = w, cfg, masks, q
        self.heads = cfg["num_heads"]
        self.tanh = bool(cfg.get("gelu_approx", False))

    def lin(self, x: torch.Tensor, name: str) -> torch.Tensor:
        y = self.q(x) @ self.q(self.w[f"{name}.weight"]).t()
        bias = self.w.get(f"{name}.bias")
        return y if bias is None else y + bias

    def norm(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return F.layer_norm(x, (x.shape[-1],), self.w[f"{name}.weight"], self.w[f"{name}.bias"],
                            1e-5)

    def gelu(self, x: torch.Tensor, tanh: bool) -> torch.Tensor:
        return F.gelu(x, approximate="tanh" if tanh else "none")

    def split(self, x: torch.Tensor) -> torch.Tensor:
        B, n, H = x.shape
        return x.reshape(B, n, self.heads, H // self.heads).transpose(1, 2)

    def attend(self, q, k, v, drop: bool) -> torch.Tensor:
        q, k, v = self.split(q), self.split(k), self.split(v)
        p = torch.softmax((self.q(q) @ self.q(k).transpose(-1, -2)) * q.shape[-1] ** -0.5, -1)
        if drop:
            p = self.masks(p)
        o = self.q(p) @ self.q(v)
        return o.transpose(1, 2).reshape(o.shape[0], o.shape[2], -1)

    def self_attention(self, x: torch.Tensor, p: str) -> torch.Tensor:
        q, k, v = self.lin(x, f"{p}.to_qkv").chunk(3, dim=-1)
        return self.masks(self.lin(self.attend(q, k, v, False), f"{p}.to_out.0"))

    def cross_attention(self, x: torch.Tensor, p: str) -> torch.Tensor:
        o = self.attend(self.lin(x[:, :1], f"{p}.wq"), self.lin(x, f"{p}.wk"),
                        self.lin(x, f"{p}.wv"), True)
        return self.masks(self.lin(o, f"{p}.proj"))

    def ffn(self, x: torch.Tensor, p: str, tanh: bool) -> torch.Tensor:
        h = self.masks(self.gelu(self.lin(x, f"{p}.0"), tanh))
        return self.masks(self.lin(h, f"{p}.3"))

    def embed(self, img: torch.Tensor) -> list[torch.Tensor]:
        return [self.lin(patchify(img[:, m], self.cfg["patch_size"]), "patch_to_embedding")
                for m in range(img.shape[1])]

    def with_cls(self, x: torch.Tensor) -> torch.Tensor:
        cls = self.w["cls_token"].expand(x.shape[0], 1, x.shape[-1])
        return self.masks(torch.cat([cls, x], 1) + self.w["pos_embedding"])

    def self_block(self, x: torch.Tensor, p: str, attn: str, ffn: str) -> torch.Tensor:
        x = self.self_attention(self.norm(x, f"{p}.{attn}.norm"), f"{p}.{attn}.fn") + x
        return self.ffn(self.norm(x, f"{p}.{ffn}.norm"), f"{p}.{ffn}.fn.net", self.tanh) + x

    def model_cross(self, img: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        streams = [self.with_cls(x) for x in self.embed(img)]
        order = {int(i): int(j) for i, j in cfg["attn_order"].items()}
        for b in range(cfg["num_multi_blocks"]):
            attn = []
            for s, x in enumerate(streams):
                for j in range(cfg["num_self_blocks"]):
                    x = self.self_block(x, f"transformer.{b}.blocks.{s}.{j}", "attn", "ffn")
                attn.append(x)
            streams, fused_i = [], 0
            for i, x in enumerate(attn):
                if i not in order:
                    streams.append(x)
                    continue
                p = f"transformer.{b}.fusion.{fused_i}"
                tmp = torch.cat([x[:, :1], attn[order[i]][:, 1:]], 1)
                cls = self.cross_attention(self.norm(tmp, f"{p}.attn.norm"), f"{p}.attn.fn")
                cls = cls + tmp[:, :1]
                cls = self.ffn(self.norm(cls, f"{p}.ffn.norm"), f"{p}.ffn.fn.net", self.tanh) + cls
                streams.append(torch.cat([cls, x[:, 1:]], 1))
                fused_i += 1
        heads = [self.ffn(self.norm(x[:, 0], f"norm.{m}"), f"mlp_head.{m}", self.tanh)
                 for m, x in enumerate(streams)]
        return torch.stack(heads).mean(0)

    def model_vit(self, img: torch.Tensor) -> torch.Tensor:
        x = self.with_cls(torch.cat(self.embed(img), 1))
        for i in range(self.cfg["num_layers"]):
            x = self.self_block(x, f"transformer.layers.{i}", "0", "2")
        h = self.norm(x[:, 0], "mlp_head.0")
        h = self.masks(self.gelu(self.lin(h, "mlp_head.1"), False))
        return self.masks(self.lin(h, "mlp_head.4"))


class Layout:
    """name → shape of every weight in the reference's state-dict layout,
    filled in the order the names are added (the order ``inputs.make_weights``
    draws them in)."""

    def __init__(self, cfg: dict):
        self.cfg, self.H, self.out = cfg, cfg["hidden_dim"], {}

    def linear(self, name: str, n_in: int, n_out: int, bias: bool = True) -> None:
        self.out[f"{name}.weight"] = (n_out, n_in)
        if bias:
            self.out[f"{name}.bias"] = (n_out,)

    def norm(self, name: str) -> None:
        self.out[f"{name}.weight"], self.out[f"{name}.bias"] = (self.H,), (self.H,)

    def self_block(self, p: str, attn: str, ffn: str) -> None:
        H, mlp = self.H, self.cfg["mlp_dim"]
        self.norm(f"{p}.{attn}.norm")
        self.linear(f"{p}.{attn}.fn.to_qkv", H, 3 * H, bias=False)
        self.linear(f"{p}.{attn}.fn.to_out.0", H, H)
        self.norm(f"{p}.{ffn}.norm")
        self.linear(f"{p}.{ffn}.fn.net.0", H, mlp)
        self.linear(f"{p}.{ffn}.fn.net.3", mlp, H)

    def stem(self, tokens: int) -> None:
        """The positional embedding over ``tokens``, the CLS token and the
        shared patch embedding."""
        (p1, p2, p3), H = self.cfg["patch_size"], self.H
        self.out["pos_embedding"], self.out["cls_token"] = (1, tokens, H), (1, 1, H)
        self.linear("patch_to_embedding", p1 * p2 * p3 * self.cfg["in_channels"], H)


def patches(cfg: dict) -> int:
    (d, h, w), (p1, p2, p3) = cfg["img_size"], cfg["patch_size"]
    return (d // p1) * (h // p2) * (w // p3)


def model_cross_shapes(cfg: dict) -> dict:
    """ModelCross's weights: a stream's tokens behind the CLS token; the
    per-stream self blocks and the fusion blocks of each multi block; the
    per-stream norms, then the per-stream heads."""
    H, mlp, M = cfg["hidden_dim"], cfg["mlp_dim"], cfg["num_modalities"]
    lay = Layout(cfg)
    lay.stem(patches(cfg) + 1)
    for b in range(cfg["num_multi_blocks"]):
        for s in range(M):
            for j in range(cfg["num_self_blocks"]):
                lay.self_block(f"transformer.{b}.blocks.{s}.{j}", "attn", "ffn")
        for c in range(len(cfg["attn_order"])):
            p = f"transformer.{b}.fusion.{c}"
            lay.norm(f"{p}.attn.norm")
            for part in ("wq", "wk", "wv", "proj"):
                lay.linear(f"{p}.attn.fn.{part}", H, H)
            lay.norm(f"{p}.ffn.norm")
            lay.linear(f"{p}.ffn.fn.net.0", H, mlp)
            lay.linear(f"{p}.ffn.fn.net.3", mlp, H)
    for m in range(M):
        lay.norm(f"norm.{m}")
    for m in range(M):
        lay.linear(f"mlp_head.{m}.0", H, mlp)
        lay.linear(f"mlp_head.{m}.3", mlp, cfg["num_classes"])
    return lay.out


def model_vit_shapes(cfg: dict) -> dict:
    """ModelVIT's weights: every stream's tokens behind one CLS token, the
    layers, the head."""
    H, mlp = cfg["hidden_dim"], cfg["mlp_dim"]
    lay = Layout(cfg)
    lay.stem(patches(cfg) * cfg["num_modalities"] + 1)
    for i in range(cfg["num_layers"]):
        lay.self_block(f"transformer.layers.{i}", "0", "2")
    lay.norm("mlp_head.0")
    lay.linear("mlp_head.1", H, mlp)
    lay.linear("mlp_head.4", mlp, cfg["num_classes"])
    return lay.out
