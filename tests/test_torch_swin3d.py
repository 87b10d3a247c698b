"""SwinViT3D (``models/swin3d.py``) and its window attention
(``ops/window_attention.py``, ``kernels/window_attention.py``) against the
benchmark's plain float32 reference (``portbench/reference/families/
SwinViT3D.py``, MONAI's ``swin_unetr`` written out), on the CPU at tiny
widths: the layout, the relative index and the region mask on hand-built
cases and against MONAI's own construction, logits and one step's
gradients (the bias tables included) with padded, shifted, unshifted and
clipped windows through all four stages and their merging, the kernels'
plain versions against the reference's attention, the checkpoint tree and
the experiments CLI.  ``card``: the kernels (K9 and the window layout's
gathers) against their plain versions at the four published stage shapes,
and the layout's gathers in a train step, bit for bit against PyTorch's
chain.

Tolerances on the CPU compare two float32 computations of the same
function whose sums run in other orders (a Conv3d against a patchify and a
matmul, the scale applied to q or to q·kᵀ, a fused softmax against
logsumexp), so they agree to a few units in the sixth digit; the tests
hold them to 1e-5 relative, loose enough for that and far below any
change of the mathematics (a missing bias, mask or merge order moves the
logits by 1e-2 or more)."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cross_attention_vit_tpu_torch.configs import get_swin3d_config, modify_config
from cross_attention_vit_tpu_torch.kernels import window_attention as wa
from cross_attention_vit_tpu_torch.kernels import window_layout as wl
from cross_attention_vit_tpu_torch.models import convert
from cross_attention_vit_tpu_torch.models.swin3d import SwinViT3D
from cross_attention_vit_tpu_torch.ops.window_attention import geometry, get_window_size
from portbench import inputs
from portbench.reference.families import SwinViT3D as ref

CPU = torch.device("cpu")
TINY = dict(feature_size=8, swin_heads=(1, 2, 2, 4))
# img_size → what its token grid exercises
CASES = {
    "padded": (36, 20, 12),      # 18×10×6: padded and shifted on two axes, w clipped to 6
    "published_window": (32, 32, 32),   # 16³ then 8³: 7³ windows padded to 21³ and 14³
    "clipped": (12, 10, 8),      # 6×5×4: every axis one window, no shift anywhere
}


def _cfg(img_size, **extra) -> tuple:
    cfg = get_swin3d_config()
    modify_config(cfg, {**TINY, "img_size": img_size, **extra})
    fields = {k: list(v) if isinstance(v, tuple) else v for k, v in cfg.to_dict().items()}
    return cfg, fields


def _model_and_weights(img_size, seed: int = 5):
    cfg, fields = _cfg(img_size)
    model = SwinViT3D(cfg, device="cpu", master_weights=True)
    w = inputs.make_weights(ref.shapes(fields), seed, CPU, ref.weight_kind)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(w[n])
    return model, fields, w


def _img(img_size, batch: int = 2, seed: int = 7) -> torch.Tensor:
    return torch.randn((batch, 4, 1, *img_size), generator=torch.Generator().manual_seed(seed))


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.detach(), b.detach()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


# --- the layout ------------------------------------------------------------------

@pytest.mark.parametrize("img_size", [(128, 128, 128), *CASES.values()],
                         ids=["published", *CASES])
def test_named_parameters_equal_the_references_layout(img_size):
    cfg = get_swin3d_config()
    if img_size != (128, 128, 128):
        modify_config(cfg, {**TINY, "img_size": img_size})
    fields = {k: list(v) if isinstance(v, tuple) else v for k, v in cfg.to_dict().items()}
    model = SwinViT3D(cfg, device="meta", master_weights=True)
    assert {n: tuple(p.shape) for n, p in model.named_parameters()} == ref.shapes(fields)


def test_the_published_encoder_has_its_widths():
    model = SwinViT3D(get_swin3d_config(), device="meta", master_weights=True)
    shapes = dict((n, tuple(p.shape)) for n, p in model.named_parameters())
    assert shapes["swinViT.patch_embed.proj.weight"] == (48, 4, 2, 2, 2)
    for s, (C, K) in enumerate(zip((48, 96, 192, 384), (3, 6, 12, 24)), start=1):
        for j in range(2):
            b = f"swinViT.layers{s}.0.blocks.{j}"
            assert shapes[f"{b}.attn.relative_position_bias_table"] == (13 ** 3, K)
            assert shapes[f"{b}.attn.qkv.weight"] == (3 * C, C) and C // K == 16
            assert shapes[f"{b}.mlp.linear1.weight"] == (4 * C, C)
        assert shapes[f"swinViT.layers{s}.0.downsample.reduction.weight"] == (2 * C, 8 * C)
        assert f"swinViT.layers{s}.0.blocks.2.norm1.weight" not in shapes
    assert shapes["head.weight"] == (2, 768)
    assert 7.5e6 < model.num_params() < 8.5e6


# --- the relative index and the mask ---------------------------------------------

def test_relative_index_on_a_hand_built_window():
    """A 2³ window: index(i, j) = (Δd+1)·9 + (Δh+1)·3 + (Δw+1), Δ = i − j."""
    geom = wa.WindowGeometry((2, 2, 2), (1, 1, 1), (0, 0, 0), (2, 2, 2))
    idx = wa.relative_index(geom)
    assert idx.shape == (8, 8) and geom.table_rows == 27
    assert idx[0, 0] == 13 and idx[0, 7] == 0 and idx[7, 0] == 26 and idx[1, 0] == 14
    assert (idx.diagonal() == 13).all()


@pytest.mark.parametrize("window, n", [((7, 7, 7), 343), ((7, 7, 7), 196), ((3, 2, 4), 24)])
def test_relative_index_is_monais_cut_to_n(window, n):
    geom = wa.WindowGeometry((n, 1, 1), (1, 1, 1), (0, 0, 0), window)
    assert torch.equal(wa.relative_index(geom), ref.relative_position_index(window)[:n, :n])


def test_region_mask_on_a_hand_built_case():
    """Four tokens on d, windows of 2 shifted by 1: the first window holds
    region 0 twice, the second regions 1 and 2."""
    geom = geometry((4, 1, 1), (2, 2, 2), shifted=True)
    assert geom.window == (2, 1, 1) and geom.shift == (1, 0, 0) and geom.grid == (2, 1, 1)
    mask = wa.window_mask(geom)
    assert torch.equal(mask[0], torch.zeros(2, 2))
    assert torch.equal(mask[1], torch.tensor([[0.0, -100.0], [-100.0, 0.0]]))
    assert wa.window_mask(geometry((4, 1, 1), (2, 2, 2), shifted=False)) is None


@pytest.mark.parametrize("dims", [(14, 14, 14), (10, 9, 6), (8, 8, 8), (18, 10, 6), (9, 5, 3)])
def test_region_mask_is_monais_compute_mask(dims):
    window = (7, 7, 7)
    geom = geometry(dims, window, shifted=True)
    ws, ss = ref.get_window_size(dims, window, (3, 3, 3))
    assert (geom.window, geom.shift) == (ws, ss) == get_window_size(dims, window, (3, 3, 3))
    want = ref.compute_mask(list(geom.padded), ws, ss, CPU)
    got = wa.window_mask(geom)
    if not any(ss):
        assert got is None
        return
    assert torch.equal(got, want)


def test_a_clipped_axis_is_one_window_without_shift():
    geom = geometry((5, 9, 7), (7, 7, 7), shifted=True)
    assert geom.window == (5, 7, 7) and geom.shift == (0, 3, 0) and geom.grid == (1, 2, 1)
    assert geom.padded == (5, 14, 7) and geom.n == 245


# --- the model against the reference ------------------------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_path_logits_match_the_reference(case):
    model, fields, w = _model_and_weights(CASES[case])
    img = _img(CASES[case])
    with torch.no_grad():
        got = model(img)
        want = ref.logits(w, fields, img, None, lambda x: x)
    assert got.shape == (2, 2)
    assert _rel(got, want) < 1e-5, (got, want)


def _worst_grad(got: dict, want: dict) -> tuple[float, str]:
    """The largest relative gap of a gradient and its leaf.  A key bias
    (``…k_bias``) has no gradient in exact arithmetic (the softmax cancels
    q·b_k): both sides must hold it below 1e-5 of its block's value-bias
    gradient, and it is not compared as a ratio of two roundings."""
    for n in (n for n in want if n.endswith("k_bias")):
        scale = want[n.replace("k_bias", "v_bias")].norm()
        assert got[n].norm() <= 1e-5 * scale and want[n].norm() <= 1e-5 * scale, n
    return max((_rel(g, want[n]), n) for n, g in got.items()
               if want[n].norm() > 0 and not n.endswith("k_bias"))


@pytest.mark.parametrize("case", sorted(CASES))
def test_one_steps_gradients_match_the_reference(case):
    """Every parameter's gradient of the mean cross-entropy, the bias
    tables included, on the kernel path (its plain versions here); the key
    biases as ``_worst_grad`` holds them."""
    model, fields, w = _model_and_weights(CASES[case])
    model.impl = "kernel"
    img, labels = _img(CASES[case]), torch.tensor([0, 1])
    _, loss = model(img, labels, train=True)
    loss.backward()
    ws = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    F.cross_entropy(ref.logits(ws, fields, img, None, lambda x: x), labels).backward()
    worst = _worst_grad({n: p.grad for n, p in model.named_parameters()},
                        {n: p.grad for n, p in ws.items()})
    assert worst[0] < 1e-4, worst
    tables = [n for n in ws if n.endswith("relative_position_bias_table")]
    # (a one-token window's softmax has no gradient: only the first stage's is sure)
    assert len(tables) == 8 and all(ws[n].grad.norm() > 0 for n in tables if "layers1" in n)


def test_kernel_and_plain_paths_agree_in_float32():
    model, _, _ = _model_and_weights(CASES["padded"])
    img, labels = _img(CASES["padded"]), torch.tensor([1, 0])
    grads = {}
    for impl in ("plain", "kernel"):
        model.impl = impl
        model.zero_grad()
        logits, loss = model(img, labels, train=True)
        loss.backward()
        grads[impl] = (logits.detach(), {n: p.grad.clone() for n, p in model.named_parameters()})
    assert _rel(grads["kernel"][0], grads["plain"][0]) < 1e-6
    assert _worst_grad(grads["kernel"][1], grads["plain"][1])[0] < 1e-5


# --- the kernels' plain versions against the reference's attention -------------------

@pytest.mark.parametrize("dims, shifted", [((10, 9, 6), True), ((10, 9, 6), False),
                                           ((14, 8, 7), True)])
def test_kernel_plain_versions_match_the_references_attention(dims, shifted):
    """x → qkv Linear → WindowAttention (its CPU branch: the kernels' plain
    versions) → proj, against the reference's ``WindowAttention.forward``
    on the same windows: outputs and the gradients of x, the qkv and proj
    weights and the bias table."""
    K, D, B = 2, 8, 2
    C = K * D
    geom = geometry(dims, (7, 7, 7), shifted)
    g = torch.Generator().manual_seed(3)
    x = torch.randn(B * geom.windows, geom.n, C, generator=g)
    bias = torch.randn(3 * C, generator=g) * 0.2
    w = {"a.qkv.weight": torch.randn(3 * C, C, generator=g) * 0.2,
         "a.q_bias": bias[:C], "a.k_bias": bias[C:2 * C], "a.v_bias": bias[2 * C:],
         "a.proj.weight": torch.randn(C, C, generator=g) * 0.2,
         "a.proj.bias": torch.randn(C, generator=g) * 0.2,
         "a.relative_position_bias_table": torch.randn(geom.table_rows, K, generator=g)}
    mine = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    theirs = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    xm, xt = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    qkv_bias = torch.cat([mine[f"a.{part}_bias"] for part in "qkv"])
    qkv = (xm @ mine["a.qkv.weight"].t() + qkv_bias).view(-1, geom.n, 3, K, D)
    o = wa.WindowAttention.apply(qkv, mine["a.relative_position_bias_table"], geom, D ** -0.5)
    got = o @ mine["a.proj.weight"].t() + mine["a.proj.bias"]
    net = ref._Net(theirs, {"window_size": [7, 7, 7]}, lambda t: t)
    mask = (ref.compute_mask(list(geom.padded), geom.window, geom.shift, CPU)
            if geom.shifted else None)
    want = net.attention(xt, "a", K, mask)
    assert _rel(got, want) < 1e-5
    cot = torch.randn(got.shape, generator=g)
    (got * cot).sum().backward()
    (want * cot).sum().backward()
    assert _rel(xm.grad, xt.grad) < 1e-5
    worst = _worst_grad({k: v.grad for k, v in mine.items()}, {k: v.grad for k, v in theirs.items()})
    assert worst[0] < 1e-5, worst


@pytest.mark.parametrize("dims, shifted", [((10, 9, 6), True), ((8, 7, 7), False)])
def test_the_table_pass_reads_every_pair_of_each_row_once(dims, shifted):
    """The backward's table pass adds, for table row r, the partial sums at
    ``_pairs_host``'s places i·nb + j: exactly the (i, j) whose relative
    index is r, in row-major order, and −1 past the row's last pair."""
    geom = geometry(dims, (7, 7, 7), shifted)
    nb = wa._cdiv(geom.n, wa.BIAS_COLS) * wa.BIAS_COLS
    pairs = wa._pairs_host(geom, nb)
    idx = wa.relative_index(geom).numpy()
    assert pairs.shape == (np.bincount(idx.ravel()).max(), geom.table_rows)
    for r in range(geom.table_rows):
        col = pairs[:, r]
        used = col[col >= 0]
        assert (col[len(used):] == -1).all()
        i, j = np.nonzero(idx == r)
        assert used.tolist() == (i * nb + j).tolist()


def test_the_table_gradient_is_the_sum_over_index_classes():
    """dtable[r, h] = Σ over the windows and the (i, j) with index r of dS."""
    geom = geometry((8, 7, 7), (7, 7, 7), True)
    g = torch.Generator().manual_seed(5)
    qkv = torch.randn(geom.windows, geom.n, 3, 1, 16, generator=g)
    table = torch.randn(geom.table_rows, 1, generator=g, requires_grad=True)
    do = torch.randn(geom.windows, geom.n, 16, generator=g)
    o, lse = wa.window_attention_fwd(qkv, table.detach(), geom, 0.25)
    _, dtable = wa.window_attention_bwd(qkv, table.detach(), o, do, lse, geom, 0.25)
    (wa.window_attention_reference(qkv, table, geom, 0.25)[0] * do).sum().backward()
    assert _rel(dtable, table.grad) < 1e-5
    idx = wa.relative_index(geom)
    unused = torch.ones(geom.table_rows, dtype=torch.bool)
    unused[idx.flatten()] = False
    assert (dtable[unused] == 0).all()


def test_the_wrappers_check_their_operands():
    geom = geometry((8, 8, 8), (7, 7, 7), False)
    qkv = torch.zeros(geom.windows, geom.n, 3, 2, 16)
    with pytest.raises(ValueError, match="bias table"):
        wa.window_attention_fwd(qkv, torch.zeros(geom.table_rows, 3), geom, 0.25)
    with pytest.raises(ValueError, match="whole number"):
        wa.window_attention_fwd(qkv[:-1], torch.zeros(geom.table_rows, 2), geom, 0.25)


# --- checkpoints and the CLI -----------------------------------------------------------

def test_the_checkpoint_tree_round_trips():
    model, _, _ = _model_and_weights(CASES["clipped"])
    tree = convert.jax_params_from_model(model)
    assert set(tree) == {"swinViT", "head"}
    other, _, _ = _model_and_weights(CASES["clipped"], seed=9)
    convert.load_jax_params(other, tree)
    for (n, p), q in zip(model.named_parameters(), other.parameters()):
        assert torch.equal(p, q), n


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    from cross_attention_vit_tpu_torch.data.nifti import write_volume

    root = tmp_path_factory.mktemp("swin_cli")
    r = np.random.default_rng(0)
    rows = []
    for i in range(1, 13):
        rows.append(f"UCSF-PDGM-{i},{'positive' if i % 3 == 0 else 'negative'}")
        case = f"UCSF-PDGM-{i:04d}"
        (root / "data" / f"{case}_nifti").mkdir(parents=True)
        for m in ("T1", "T1c", "T2", "FLAIR"):
            write_volume(root / "data" / f"{case}_nifti" / f"{case}_{m}.nii.gz",
                         r.integers(0, 900, size=(18, 17, 16)).astype(np.int16), scl_slope=1.0)
    (root / "labels.csv").write_text("ID,MGMT status\n" + "\n".join(rows) + "\n")
    return root


def test_experiments_cli_trains_swin3d(cohort, tmp_path):
    from cross_attention_vit_tpu_torch.drivers import experiments

    sets = ["--set", "img_size=(16, 16, 16)", "--set", "feature_size=8", "--set",
            "swin_heads=(1, 2, 2, 4)"]
    out = experiments.main(["--model", "swin3d", "--grid-index", "0", "--seeds", "2004",
                            "--batch-size", "2", "--epochs", "1", "--only-available",
                            "--labels", str(cohort / "labels.csv"), "--data",
                            str(cohort / "data"), "--out", str(tmp_path), *sets], device="cpu")
    assert list(out) == ["test_200_0_2_0"]
    row = out["test_200_0_2_0"][0]
    assert math.isfinite(row["train_loss"]) and math.isfinite(row["val_loss"])
    assert list((tmp_path / "checkpoints" / "cross").glob("*test_200_0_2_0*"))


@pytest.mark.parametrize("model, want", [("both", ["ModelCross", "ModelVIT"]),
                                         ("swin3d", ["SwinViT3D"]), ("vit", ["ModelVIT"])])
def test_the_cli_picks_the_models(cohort, monkeypatch, model, want):
    from cross_attention_vit_tpu_torch.drivers import experiments

    seen = []
    monkeypatch.setattr(experiments, "_run_one",
                        lambda cls, cfg, *a, **kw: (seen.append((cls.__name__, cfg)), None,
                                                    [{}])[1:])
    experiments.main(["--model", model, "--grid-index", "0", "--seeds", "2004",
                      "--only-available", "--labels", str(cohort / "labels.csv"), "--data",
                      str(cohort / "data")], device="cpu")
    assert [name for name, _ in seen] == want
    for name, cfg in seen:
        if name == "SwinViT3D":
            assert cfg.window_size == (7, 7, 7) and cfg.img_types == ("T1", "T1c", "T2", "FLAIR")


# --- on the card -------------------------------------------------------------------

# (token grid, heads) of the four published stages at 128³
STAGES = {"stage1": ((64, 64, 64), 3), "stage2": ((32, 32, 32), 6),
          "stage3": ((16, 16, 16), 12), "stage4": ((8, 8, 8), 24)}


@pytest.mark.card
@pytest.mark.parametrize("stage", sorted(STAGES))
@pytest.mark.parametrize("shifted", [False, True])
def test_kernels_match_their_plain_versions_on_the_card(stage, shifted):
    """At B = 16 and the stage's published shape, bf16: the kernels against
    their plain versions, which round where the kernels round.  o differs
    by the rounding of P to bf16 before PV (the kernel's unnormalised, the
    plain version's normalised) and of o itself, each within 2^-9 a value:
    within 1e-2 in norm.  lse is f32 in both: 1e-5.  The backward takes the
    kernel's own o and lse, so dq, dk and dv differ by f32 summation order
    and the rare flip of a bf16 rounding: 1e-3 in norm; the table gradient
    is f32 throughout: 1e-5.  Two backward calls give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dims, K = STAGES[stage]
    geom = geometry(dims, (7, 7, 7), shifted)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)
    BW, n, D = 16 * geom.windows, geom.n, 16
    qkv = torch.randn(BW, n, 3, K, D, device=dev, generator=g).to(torch.bfloat16)
    table = torch.randn(geom.table_rows, K, device=dev, generator=g) * 0.5
    do = torch.randn(BW, n, K * D, device=dev, generator=g).to(torch.bfloat16)
    f0, b0 = wa.window_attention_fwd.launches, wa.window_attention_bwd.launches
    o, lse = wa.window_attention_fwd(qkv, table, geom, 0.25)
    dqkv, dtable = wa.window_attention_bwd(qkv, table, o, do, lse, geom, 0.25)
    again = wa.window_attention_bwd(qkv, table, o, do, lse, geom, 0.25)
    assert (wa.window_attention_fwd.launches - f0, wa.window_attention_bwd.launches - b0) == (1, 2)
    assert torch.equal(dqkv, again[0]) and torch.equal(dtable, again[1])
    # the plain versions materialise (BW, K, n, n) f32: two samples at a time
    rows, errors, rdtable = 2 * geom.windows, {k: [] for k in ("o", "lse", "dqkv")}, 0
    for a in range(0, BW, rows):
        w = slice(a, a + rows)
        ro, rlse = wa.window_attention_reference(qkv[w], table, geom, 0.25)
        errors["o"].append(((o[w].float() - ro.float()).norm() ** 2, ro.float().norm() ** 2))
        errors["lse"].append(((lse[w] - rlse).norm() ** 2, rlse.norm() ** 2))
        rdqkv, dt = wa.window_attention_backward_reference(qkv[w], table, o[w], do[w], lse[w],
                                                           geom, 0.25)
        diff = (dqkv[w].float() - rdqkv.float()).pow(2).sum((0, 1, 3, 4))
        errors["dqkv"].append((diff, rdqkv.float().pow(2).sum((0, 1, 3, 4))))
        rdtable = rdtable + dt
    rel = {k: (sum(e for e, _ in v) / sum(r for _, r in v)).sqrt() for k, v in errors.items()}
    assert rel["o"] < 1e-2 and rel["lse"] < 1e-5, rel
    assert (rel["dqkv"] < 1e-3).all(), rel
    assert _rel(dtable, rdtable) < 1e-5


@pytest.mark.card
def test_a_bf16_train_step_launches_eight_window_attention_calls_each_way_on_the_card():
    """The published encoder at 128³, bf16, through ``make_train_step``:
    one window-attention forward and one backward a block, 8 each a step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from cross_attention_vit_tpu_torch.train.optim import Adam
    from cross_attention_vit_tpu_torch.train.trainer import make_train_step

    cfg = get_swin3d_config()
    modify_config(cfg, dict(compute_dtype="bfloat16", activation_dtype="bfloat16",
                            augment_dtype="bfloat16", use_flash_attention=True))
    model = SwinViT3D(cfg, device="cuda", generator=torch.Generator(device="cuda").manual_seed(0),
                      master_weights=True)
    step = make_train_step(model, Adam(model.parameters(), cfg.weight_decay), cfg)
    img = torch.randn((2, 4, 1, 128, 128, 128), device="cuda").to(torch.bfloat16)
    labels = torch.tensor([0, 1], device="cuda")
    step(img, labels, cfg.lr, torch.Generator().manual_seed(1))
    f0, b0 = wa.window_attention_fwd.launches, wa.window_attention_bwd.launches
    aux = step(img, labels, cfg.lr, torch.Generator().manual_seed(2))
    assert (wa.window_attention_fwd.launches - f0, wa.window_attention_bwd.launches - b0) == (8, 8)
    assert math.isfinite(float(aux["loss"]))


@pytest.mark.card
@pytest.mark.parametrize("stage", sorted(STAGES))
@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_layout_kernels_match_their_plain_versions_on_the_card(stage, shifted, dtype):
    """At B = 16, the stage's published grid and width (C = 16 per head):
    the pack and the unpack, and each one's backward (the other kernel),
    equal PyTorch's chain and its autograd bit for bit; one launch of each
    kernel a direction."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dims, K = STAGES[stage]
    geom = geometry(dims, (7, 7, 7), shifted)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(13)
    C = 16 * K
    x = torch.randn(16, *dims, C, device=dev, generator=g).to(dtype).requires_grad_()
    o = torch.randn(16 * geom.windows, geom.n, C, device=dev, generator=g).to(dtype)
    o.requires_grad_()
    dy, dz = torch.randn_like(o), torch.randn_like(x)
    p0, u0 = wl.window_pack.launches, wl.window_unpack.launches
    y, z = wl.window_pack(x, geom), wl.window_unpack(o, geom, dims)
    gx, go = torch.autograd.grad([y, z], [x, o], [dy, dz])
    torch.cuda.synchronize()
    assert (wl.window_pack.launches - p0, wl.window_unpack.launches - u0) == (2, 2)
    assert torch.equal(y, wl.window_pack_reference(x.detach(), geom))
    assert torch.equal(z, wl.window_unpack_reference(o.detach(), geom, dims))
    want_gx, want_go = torch.autograd.grad(
        [wl.window_pack_reference(x, geom), wl.window_unpack_reference(o, geom, dims)],
        [x, o], [dy, dz])
    assert torch.equal(gx, want_gx) and torch.equal(go, want_go)


def _card_swin(batch: int):
    cfg = get_swin3d_config()
    modify_config(cfg, dict(compute_dtype="bfloat16", activation_dtype="bfloat16",
                            augment_dtype="bfloat16", use_flash_attention=True))
    model = SwinViT3D(cfg, device="cuda", generator=torch.Generator(device="cuda").manual_seed(0),
                      master_weights=True)
    img = torch.randn((batch, 4, 1, 128, 128, 128), device="cuda").to(torch.bfloat16)
    return cfg, model, img, torch.arange(batch, device="cuda") % 2


@pytest.mark.card
def test_a_bf16_train_step_gathers_its_layout_and_rolls_nothing_on_the_card():
    """The published encoder at 128³, bf16, through ``make_train_step``:
    the pack and the unpack each 8 times forward and 8 times backward a
    step, and no ``torch.roll`` kernel in its profile."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile

    from cross_attention_vit_tpu_torch.train.optim import Adam
    from cross_attention_vit_tpu_torch.train.trainer import make_train_step

    cfg, model, img, labels = _card_swin(2)
    step = make_train_step(model, Adam(model.parameters(), cfg.weight_decay), cfg)
    step(img, labels, cfg.lr, torch.Generator().manual_seed(1))
    p0, u0 = wl.window_pack.launches, wl.window_unpack.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(img, labels, cfg.lr, torch.Generator().manual_seed(2))
        torch.cuda.synchronize()
    assert (wl.window_pack.launches - p0, wl.window_unpack.launches - u0) == (16, 16)
    names = [ev.key for ev in prof.key_averages()]
    assert any("window_layout_pack" in k for k in names), names
    assert not any("roll_cuda_kernel" in k for k in names), names


@pytest.mark.card
def test_the_layout_kernels_leave_a_bf16_steps_loss_and_gradients_unchanged_on_the_card(
        monkeypatch):
    """The published encoder at 128³, bf16, batch 2: the loss and every
    parameter's gradient with the layout's gathers equal those with
    PyTorch's chain in their place, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from cross_attention_vit_tpu_torch.ops import window_attention as ops_wa

    _, model, img, labels = _card_swin(2)
    params = [p for p in model.parameters() if p.requires_grad]
    readings = []
    for pack, unpack in ((wl.window_pack, wl.window_unpack),
                         (wl.window_pack_reference, wl.window_unpack_reference)):
        monkeypatch.setattr(ops_wa, "window_pack", pack)
        monkeypatch.setattr(ops_wa, "window_unpack", unpack)
        _, loss = model(img, labels, train=True)
        readings.append((loss.detach(), torch.autograd.grad(loss, params)))
    (loss, grads), (want_loss, want_grads) = readings
    assert torch.equal(loss, want_loss)
    assert all(torch.equal(a, b) for a, b in zip(grads, want_grads))
