"""MViTv2 (``models/mvit.py``), its pooling attention
(``ops/pooling_attention.py``) and K10 (``kernels/pool_attention.py``)
against the benchmark's plain float32 reference (``portbench/reference/
families/MViTv2.py``, PySlowFast's MViT written out), on the CPU at tiny
widths: the layout and the published widths, the block schedule, the
relative-position distances and the bias terms against a direct gather,
logits, the loss and every gradient of one step with dropout and drop path
drawn in the port's order, the kernels' plain versions against
materialised attention with the bias and the ``+ q`` residual.  ``card``:
K10 against its plain version at each stage's shapes, a bf16 train step's
launches, and a bf16 step at the cell's size against the f32 reference
within the cell's limits.

Tolerances on the CPU compare two float32 computations of the same function
whose sums run in other orders (a batched product against an einsum, the
scale applied to q or to q·kᵀ, a fused softmax against logsumexp), so they agree to a few units in the sixth digit;
the tests hold them to 1e-5 relative, far below any change of the
mathematics (a missing bias term or residual moves the logits by 1e-2 or
more)."""

from __future__ import annotations

import json
import math
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from cross_attention_vit_tpu_torch.configs import get_mvitv2_s_config, modify_config
from cross_attention_vit_tpu_torch.kernels import pool_attention as pa
from cross_attention_vit_tpu_torch.models.mvit import MViTv2, block_plan
from cross_attention_vit_tpu_torch.ops import pooling_attention as pops
from portbench import inputs
from portbench.reference.families import MViTv2 as ref
from portbench.reference.train import Masks

CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[1]
# name → tiny overrides; each keeps every kind of block: a transition with
# the skip path, key strides above and at 1, heads doubling
CASES = {
    "two_transitions": dict(img_size=(4, 32, 32), embed_dim=16, depth=4, dim_mul_blocks=(1, 3),
                            pool_kv_stride_adaptive=(1, 4, 4), num_classes=5),
    "temporal_and_uneven": dict(img_size=(6, 24, 40), embed_dim=8, depth=3, dim_mul_blocks=(1,),
                                pool_q_stride=(2, 2, 2), pool_kv_stride_adaptive=(2, 2, 4),
                                num_classes=3),
}


# the CPU tests compute in float32
F32 = dict(compute_dtype="float32", activation_dtype="float32", augment_dtype="float32")


def _cfg(case: str, **extra):
    cfg = get_mvitv2_s_config()
    modify_config(cfg, {**CASES[case], **F32, **extra})
    fields = {k: list(v) if isinstance(v, tuple) else v for k, v in cfg.to_dict().items()}
    return cfg, fields


def _model_and_weights(case: str, seed: int = 5, **extra):
    cfg, fields = _cfg(case, **extra)
    model = MViTv2(cfg, device="cpu", master_weights=True)
    w = inputs.make_weights(ref.shapes(fields), seed, CPU, ref.weight_kind)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(w[n])
    return model, fields, w


def _img(cfg_fields: dict, batch: int = 2, seed: int = 7) -> torch.Tensor:
    return torch.randn((batch, cfg_fields["num_modalities"], 1, *cfg_fields["img_size"]),
                       generator=torch.Generator().manual_seed(seed))


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def _worst_grad(got: dict, want: dict) -> tuple[float, str]:
    """The largest relative gap of a gradient and its leaf.  A key norm's
    bias (``…norm_k.bias``) adds q·b to a whole row of scores, which the
    softmax cancels: its gradient is nought but rounding, held below 1e-5 of
    its block's value-norm bias gradient on both sides and not compared as a
    ratio."""
    for n in (n for n in want if n.endswith("norm_k.bias")):
        scale = want[n.replace("norm_k", "norm_v")].norm()
        assert got[n].norm() <= 1e-5 * scale and want[n].norm() <= 1e-5 * scale, n
    return max((_rel(g, want[n]), n) for n, g in got.items()
               if want[n].norm() > 0 and not n.endswith("norm_k.bias"))


# --- the layout and the schedule ----------------------------------------------------

@pytest.mark.parametrize("case", ["published", *CASES])
def test_named_parameters_equal_the_references_layout(case):
    cfg = get_mvitv2_s_config()
    if case != "published":
        modify_config(cfg, CASES[case])
    fields = {k: list(v) if isinstance(v, tuple) else v for k, v in cfg.to_dict().items()}
    model = MViTv2(cfg, device="meta", master_weights=True)
    assert {n: tuple(p.shape) for n, p in model.named_parameters()} == ref.shapes(fields)


def test_the_published_model_has_its_widths_and_34_5_million_parameters():
    model = MViTv2(get_mvitv2_s_config(), device="meta", master_weights=True)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert shapes["patch_embed.proj.weight"] == (96, 3, 3, 7, 7)
    widths = [shapes[f"blocks.{i}.attn.proj.weight"][0] for i in range(16)]
    assert widths == [96] + [192] * 2 + [384] * 11 + [768] * 2
    assert all(shapes[f"blocks.{i}.attn.pool_q.weight"] == (96, 1, 3, 3, 3) for i in range(16))
    assert {i for i in range(16) if f"blocks.{i}.proj.weight" in shapes} == {1, 3, 14}
    assert shapes["blocks.0.attn.rel_pos_h"] == (111, 96) and shapes["blocks.0.attn.rel_pos_t"] == (15, 96)
    assert shapes["head.projection.weight"] == (400, 768)
    # the paper's 34.5 M
    assert model.num_params() == 34_537_648


def test_the_block_schedule_is_pyslowfasts():
    plan = block_plan(get_mvitv2_s_config())
    assert [p.heads for p in plan] == [1] + [2] * 2 + [4] * 11 + [8] * 2
    assert [i for i, p in enumerate(plan) if p.q_stride == (1, 2, 2)] == [1, 3, 14]
    kv = [p.kv_stride for p in plan]
    assert kv[0] == (1, 8, 8) and kv[1:3] == [(1, 4, 4)] * 2 and kv[3:14] == [(1, 2, 2)] * 11
    assert kv[14:] == [(1, 1, 1)] * 2
    assert [math.prod(p.k_dims) for p in plan] == [392, 1568, 392, 1568] + [392] * 10 + [1568, 392]
    assert math.prod(plan[0].q_dims) == 25_088 and plan[-1].q_dims == (8, 7, 7)
    assert plan[0].drop_path == 0.0 and plan[-1].drop_path == pytest.approx(0.2)


# --- the relative-position bias ------------------------------------------------------

@pytest.mark.parametrize("lq, lk, want", [
    (3, 3, [[2, 1, 0], [3, 2, 1], [4, 3, 2]]),
    (4, 2, [[2, 0], [3, 1], [4, 2], [5, 3]]),          # rk = 2: d = i − 2j + 2
    (2, 4, [[3, 2, 1, 0], [5, 4, 3, 2]])])             # rq = 2: d = 2i − j + 3
def test_rel_pos_index_on_hand_built_axes(lq, lk, want):
    idx = pops.rel_pos_index(lq, lk)
    assert idx.tolist() == want and int(idx.max()) < pops.table_rows(lq, lk)


@pytest.mark.parametrize("q_dims, k_dims", [((2, 4, 4), (2, 4, 4)), ((2, 4, 6), (1, 2, 3)),
                                            ((1, 2, 3), (2, 4, 6))],
                         ids=["equal", "more_queries", "more_keys"])
def test_the_bias_terms_equal_a_direct_gather(q_dims, k_dims):
    """``bias_terms``' three batched products, summed per score by
    ``bias_from_terms``, against B_rel[i, j] = q_i·Rt[dt] + q_i·Rh[dh] +
    q_i·Rw[dw] gathered pair by pair."""
    g = torch.Generator().manual_seed(3)
    D, BH = 8, 3
    q = torch.randn(BH, math.prod(q_dims), D, generator=g)
    tables = [torch.randn(pops.table_rows(a, b), D, generator=g) for a, b in zip(q_dims, k_dims)]
    e = pops.bias_terms(q, q_dims, k_dims, *tables)
    assert e.shape == (BH, math.prod(q_dims), pa.terms_width(k_dims))
    got = pa.bias_from_terms(e, k_dims)
    want = torch.empty(BH, math.prod(q_dims), math.prod(k_dims))
    for i, qc in enumerate(torch.cartesian_prod(*(torch.arange(n) for n in q_dims)).tolist()):
        for j, kc in enumerate(torch.cartesian_prod(*(torch.arange(n) for n in k_dims)).tolist()):
            rows = [int(pops.rel_pos_index(a, b)[x, y]) for a, b, x, y in zip(q_dims, k_dims, qc, kc)]
            want[:, i, j] = sum(q[:, i] @ t[r] for t, r in zip(tables, rows))
    assert _rel(got, want) < 1e-5
    assert (e[..., sum(k_dims):] == 0).all()


# --- the model against the reference ---------------------------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_path_logits_match_the_reference(case):
    model, fields, w = _model_and_weights(case)
    img = _img(fields)
    with torch.no_grad():
        got = model(img)
        want = ref.logits(w, fields, img, None, lambda x: x)
    assert got.shape == (2, fields["num_classes"])
    assert _rel(got, want) < 1e-5, (got, want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_one_steps_loss_and_gradients_match_the_reference(case):
    """Train mode through K10's wrapper (its plain versions here): the head's
    dropout and every block's two drop-path masks drawn from one generator
    in the port's order, the reference's ``Masks`` fed the same seed; the
    loss and every parameter's gradient, the relative-position tables and
    the pools included."""
    model, fields, w = _model_and_weights(case, drop_path_rate=0.5)
    img, labels = _img(fields, batch=4), torch.tensor([0, 1, 1, 0])
    _, loss = model(img, labels, train=True, generator=torch.Generator().manual_seed(9))
    loss.backward()
    ws = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    masks = Masks(torch.Generator().manual_seed(9), fields["dropout"], 4)
    want = F.cross_entropy(ref.logits(ws, fields, img, masks, lambda x: x), labels)
    want.backward()
    assert masks.drawn and len(masks.drawn) == 2 * (fields["depth"] - 1) + 1
    assert abs(float(loss.detach()) - float(want.detach())) < 1e-5 * float(want.detach())
    worst = _worst_grad({n: p.grad for n, p in model.named_parameters()},
                        {n: p.grad for n, p in ws.items()})
    assert worst[0] < 1e-4, worst
    assert all(ws[n].grad.norm() > 0 for n in ws if "rel_pos" in n or "pool_" in n)


def test_the_ports_config_is_the_cells_config():
    """``get_mvitv2_s_config`` and the benchmark's ``mvitv2_s.k400``
    configuration hold the same fields: the port trains what the cell
    measures, bf16 included."""
    conf = json.loads((ROOT / "portbench" / "configs" / "mvitv2_s.k400.json").read_text())
    mine = {k: list(v) if isinstance(v, tuple) else v
            for k, v in get_mvitv2_s_config().to_dict().items()}
    assert mine == conf["config"]


# --- K10's plain versions against materialised attention ----------------------------------

@pytest.mark.parametrize("q_dims, k_dims", [((2, 6, 6), (2, 3, 3)), ((2, 3, 3), (2, 6, 6)),
                                            ((1, 4, 5), (1, 4, 5))],
                         ids=["more_queries", "more_keys", "equal"])
def test_k10_plain_versions_match_materialised_attention(q_dims, k_dims):
    """``PoolAttention`` (its CPU branch: the kernels' plain versions, with
    their own backward) against softmax(q·kᵀ·scale + B)·v + q written out
    with autograd: o and the gradients of q, k, v and the bias terms."""
    g = torch.Generator().manual_seed(4)
    BH, D = 3, 8
    Nq, Nk, PP = math.prod(q_dims), math.prod(k_dims), pa.terms_width(k_dims)
    q, k, v = (torch.randn(BH, n, D, generator=g) for n in (Nq, Nk, Nk))
    e = torch.randn(BH, Nq, PP, generator=g)
    mine = [t.clone().requires_grad_(True) for t in (q, k, v, e)]
    theirs = [t.clone().requires_grad_(True) for t in (q, k, v, e)]
    o = pa.PoolAttention.apply(*mine, k_dims, D ** -0.5)
    tq, tk = theirs[0], theirs[1]
    tk_, hk, wk = k_dims
    et, eh, ew = theirs[3][..., :tk_], theirs[3][..., tk_:tk_ + hk], theirs[3][..., tk_ + hk:tk_ + hk + wk]
    bias = (et[..., :, None, None] + eh[..., None, :, None] + ew[..., None, None, :]).reshape(BH, Nq, Nk)
    want = torch.softmax(tq @ tk.transpose(1, 2) * D ** -0.5 + bias, -1) @ theirs[2] + tq
    assert _rel(o, want) < 1e-5
    cot = torch.randn(o.shape, generator=g)
    (o * cot).sum().backward()
    (want * cot).sum().backward()
    for a, b, name in zip(mine, theirs, "qkve"):
        assert _rel(a.grad, b.grad) < 1e-5, name


def test_the_wrappers_check_their_operands():
    q = torch.zeros(2, 12, 8)
    k = torch.zeros(2, 6, 8)
    e = torch.zeros(2, 12, pa.terms_width((1, 2, 3)))
    with pytest.raises(ValueError, match="key grid"):
        pa.pool_attention_fwd(q, k, k, e, (1, 2, 2), 0.5)
    with pytest.raises(ValueError, match="bias terms"):
        pa.pool_attention_fwd(q, k, k, e[..., :6], (1, 2, 3), 0.5)


# --- on the card -------------------------------------------------------------------------

# (query grid, key grid, heads) of MViTv2-S's seven distinct attention shapes
STAGES = {"b0": ((8, 56, 56), (8, 7, 7), 1), "b1": ((8, 28, 28), (8, 14, 14), 2),
          "b2": ((8, 28, 28), (8, 7, 7), 2), "b3": ((8, 14, 14), (8, 14, 14), 4),
          "b4": ((8, 14, 14), (8, 7, 7), 4), "b14": ((8, 7, 7), (8, 14, 14), 8),
          "b15": ((8, 7, 7), (8, 7, 7), 8)}


@pytest.mark.card
@pytest.mark.parametrize("stage", sorted(STAGES))
def test_k10_matches_its_plain_version_on_the_card(stage):
    """At B = 2 and the block's published shape, bf16: the kernels against
    their plain versions, which round where the kernels round.  o differs by
    the rounding of P to bf16 before PV (the kernel's unnormalised, the
    plain version's normalised) and of o itself, each within 2^-9 a value:
    within 1e-2 in norm.  lse is f32 in both: 1e-5.  The backward takes the
    kernel's own o and lse, so dq, dk and dv differ by f32 summation order
    and the rare flip of a bf16 rounding of P or dS, summed over up to
    25,088 queries for dk and dv: 2e-3 in norm.  de sums the f32 dS in
    both: 1e-5.  Two backward calls give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q_dims, k_dims, heads = STAGES[stage]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)
    BH, Nq, Nk, D = 2 * heads, math.prod(q_dims), math.prod(k_dims), 96
    q, k, v, do = (torch.randn(BH, n, D, device=dev, generator=g).to(torch.bfloat16)
                   for n in (Nq, Nk, Nk, Nq))
    e = (torch.randn(BH, Nq, pa.terms_width(k_dims), device=dev, generator=g) * 0.5).to(
        torch.bfloat16)
    f0, b0 = pa.pool_attention_fwd.launches, pa.pool_attention_bwd.launches
    o, lse = pa.pool_attention_fwd(q, k, v, e, k_dims, D ** -0.5)
    grads = pa.pool_attention_bwd(q, k, v, e, o, do, lse, k_dims, D ** -0.5)
    again = pa.pool_attention_bwd(q, k, v, e, o, do, lse, k_dims, D ** -0.5)
    assert (pa.pool_attention_fwd.launches - f0, pa.pool_attention_bwd.launches - b0) == (1, 2)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    P = sum(k_dims)
    sums = {name: [0.0, 0.0] for name in ("o", "lse", "dq", "dk", "dv", "de")}
    for b in range(BH):           # the plain versions materialise (Nq, Nk) f32: one at a time
        s = slice(b, b + 1)
        ro, rlse = pa.pool_attention_reference(q[s], k[s], v[s], e[s], k_dims, D ** -0.5)
        want = pa.pool_attention_backward_reference(q[s], k[s], v[s], e[s], o[s], do[s], lse[s],
                                                    k_dims, D ** -0.5)
        pairs = {"o": (o[s], ro), "lse": (lse[s], rlse), "dq": (grads[0][s], want[0]),
                 "dk": (grads[1][s], want[1]), "dv": (grads[2][s], want[2]),
                 "de": (grads[3][s][..., :P], want[3][..., :P])}
        for name, (got, ref_) in pairs.items():
            sums[name][0] += float((got.float() - ref_.float()).pow(2).sum())
            sums[name][1] += float(ref_.float().pow(2).sum())
    rel = {name: math.sqrt(a / b) for name, (a, b) in sums.items()}
    assert rel["o"] < 1e-2 and rel["lse"] < 1e-5 and rel["de"] < 1e-5, rel
    assert rel["dq"] < 2e-3 and rel["dk"] < 2e-3 and rel["dv"] < 2e-3, rel


def _card_model(batch: int):
    from cross_attention_vit_tpu_torch.train.optim import Adam
    from cross_attention_vit_tpu_torch.train.trainer import make_train_step

    cfg = get_mvitv2_s_config()
    model = MViTv2(cfg, device="cuda", generator=torch.Generator(device="cuda").manual_seed(0),
                   master_weights=True)
    step = make_train_step(model, Adam(model.parameters(), cfg.weight_decay), cfg)
    img = torch.randn((batch, 3, 1, 16, 224, 224), device="cuda").to(torch.bfloat16)
    labels = (torch.arange(batch, device="cuda") % 2)
    return cfg, step, img, labels


@pytest.mark.card
def test_a_bf16_train_step_launches_sixteen_k10_calls_each_way_on_the_card():
    """The published model at 16 × 224², bf16, through ``make_train_step``:
    one K10 forward and one backward a block, 16 each a step, and three
    pools a block."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg, step, img, labels = _card_model(2)
    step(img, labels, cfg.lr, torch.Generator().manual_seed(1))
    f0, b0, p0 = (pa.pool_attention_fwd.launches, pa.pool_attention_bwd.launches,
                  pops.mvit_pool.launches)
    aux = step(img, labels, cfg.lr, torch.Generator().manual_seed(2))
    assert (pa.pool_attention_fwd.launches - f0, pa.pool_attention_bwd.launches - b0) == (16, 16)
    assert pops.mvit_pool.launches - p0 == 48
    assert math.isfinite(float(aux["loss"]))


@pytest.mark.card
def test_a_bf16_train_step_meets_the_cells_limits_against_the_f32_reference_on_the_card():
    """The cell ``mvitv2s.train.b64`` at its own size: the program's checked
    bf16 steps against the plain f32 reference, within the cell's limits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from portbench import compare, harness

    cell = harness.load_cell("mvitv2s.train.b64")
    dev = torch.device("cuda")
    program = harness.Program(cell, 2_718_281_828, dev)
    got = program.checked_steps()
    del program
    harness.free(dev)
    want = harness.reference_readings(cell, 2_718_281_828, dev)
    checks = compare.checks(got["losses"], [got], want, cell.workload["limits"])
    assert all(c["value"] <= c["limit"] for c in checks.values()), checks
    limits = json.loads((ROOT / "portbench" / "workloads" / "mvitv2s.train.b64.json").read_text())
    assert limits["limits"] == cell.workload["limits"]
