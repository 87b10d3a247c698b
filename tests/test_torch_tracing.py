"""The port's spans (``utils/profiling.py``: ``span``, ``to_device``) and the
benchmark's readers of them (``portbench/spans.py`` and the five
``portbench/metrics`` files that read it).

* With no profiler recording, ``span`` is one shared null context.
* A tiny ModelCross train step with augmentation and ``grad_accum=2``,
  profiled on the CPU, records its four phases in order and without
  overlap, forward and backward once per microbatch, and computes the same
  losses and parameters, bit for bit, as without the profiler.
* With every transform drawn, each host copy the augmentation makes goes
  through ``to_device``: told that the CPU is a card, it opens as many
  ``sync:h2d`` spans as the code makes copies, each inside ``step:augment``.
* On synthetic events: the device's idle time clipped to each phase, the
  phases and the rest summing to the idle between operations, no reading
  without the step's spans, and the device operations the same with the
  spans' events as without.
"""

import contextlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cross_attention_vit_tpu_torch.configs import get_mgmt_cross_config, modify_config
from cross_attention_vit_tpu_torch.data.augment import AugmentConfig, augment_batch
from cross_attention_vit_tpu_torch.models.model_cross import ModelCross
from cross_attention_vit_tpu_torch.train.optim import Adam
from cross_attention_vit_tpu_torch.train.trainer import make_train_step
from cross_attention_vit_tpu_torch.utils import profiling
from portbench import harness, spans
from portbench.trace import KERNEL_CLASSES, read_profile

TINY = dict(hidden_dim=32, mlp_dim=64, num_heads=4, num_multi_blocks=1, num_self_blocks=1,
            img_size=(16, 16, 8), patch_size=(8, 8, 8), num_modalities=2,
            attn_order={"0": "1", "1": "0"}, dropout=0.1, lr=1e-3, weight_decay=5e-4,
            label_smoothing=0.0, img_aug=True)
EVERY = AugmentConfig(flip_prob=1.0, rot90_prob=1.0, affine_prob=1.0, contrast_prob=1.0,
                      noise_prob=1.0, smooth_prob=1.0, shuffle_prob=1.0, dropout_prob=1.0,
                      zoom_prob=1.0)
READERS = ("host_syncs.train", "augment_idle_ms.train", "forward_idle_ms.train",
           "backward_idle_ms.train", "optimizer_idle_ms.train")


def _step(grad_accum=2, augment_cfg=AugmentConfig()):
    cfg = get_mgmt_cross_config()
    modify_config(cfg, TINY)
    model = ModelCross(cfg, device="cpu", generator=torch.Generator().manual_seed(3),
                       master_weights=True)
    optimizer = Adam(list(model.parameters()), weight_decay=cfg.weight_decay)
    return model, make_train_step(model, optimizer, cfg, grad_accum=grad_accum,
                                  augment_cfg=augment_cfg)


def _batch(seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(4, 2, 1, 16, 16, 8, generator=g), torch.tensor([0, 1, 1, 0])


def _spans(prof, names):
    """(name, start, end) of the host events named one of ``names``, by start."""
    return sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.name in names), key=lambda r: r[1])


def test_span_without_a_profiler_is_the_shared_null_context():
    assert not torch.autograd._profiler_enabled()
    off = profiling.span("step:forward")
    assert off is profiling.span("step:backward")
    assert isinstance(off, contextlib.nullcontext)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with off:
            torch.ones(2).add_(1)
        with profiling.span("step:forward"):
            torch.ones(2).add_(1)
    names = [e.name for e in prof.events()]
    assert names.count("step:forward") == 1
    assert all(n.startswith("aten::") for n in names if n != "step:forward")


def test_span_names_are_no_kernel_class_marks():
    for name in (*spans.PHASES, spans.SYNC, profiling.SYNC_H2D):
        assert not any(m in name for _, marks in KERNEL_CLASSES for m in marks), name
    assert profiling.SYNC_H2D == spans.SYNC


def test_train_step_records_its_phases_in_order_without_overlap():
    _, step = _step(grad_accum=2)
    img, labels = _batch()
    step(img, labels, 1e-3, torch.Generator().manual_seed(1))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(img, labels, 1e-3, torch.Generator().manual_seed(2))
    got = _spans(prof, (*spans.PHASES, spans.SYNC))
    assert [n for n, _, _ in got] == ["step:augment", "step:forward", "step:backward",
                                      "step:forward", "step:backward", "step:optimizer"]
    assert all(end <= nxt for (_, _, end), (_, nxt, _) in zip(got, got[1:]))
    assert all(start < end for _, start, end in got)


def test_train_step_is_bit_equal_with_and_without_a_profiler():
    runs = []
    for profiled in (False, True):
        model, step = _step(grad_accum=2)
        losses = []
        with profile(activities=[ProfilerActivity.CPU]) if profiled else contextlib.nullcontext():
            for i in range(2):
                img, labels = _batch(i)
                losses.append(step(img, labels, 1e-3, torch.Generator().manual_seed(10 + i))
                              ["loss"].clone())
        runs.append((losses, [p.detach().clone() for p in model.parameters()]))
    (l0, p0), (l1, p1) = runs
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))


@pytest.mark.parametrize("backend,affine_copies", [("lu", 4), ("exact", 1)])
def test_every_host_copy_of_the_augmentation_is_spanned(monkeypatch, backend, affine_copies):
    """Nine gate indices, the affine's copies (one a LU pass, or the
    matrices), contrast, noise, smooth and zoom parameters, one copy of
    corners a hole; in the step also the images and the labels."""
    monkeypatch.setattr(profiling, "_host_to_card", lambda t, device: True)
    cfg = AugmentConfig(**{**EVERY.__dict__, "affine_backend": backend})
    want = 9 + affine_copies + 4 + cfg.shuffle_holes + cfg.dropout_holes
    img, labels = _batch()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        augment_batch(img, torch.Generator().manual_seed(4), cfg)
    assert len(_spans(prof, (spans.SYNC,))) == want
    _, step = _step(grad_accum=2, augment_cfg=cfg)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(img, labels, 1e-3, torch.Generator().manual_seed(5))
    syncs = _spans(prof, (spans.SYNC,))
    (_, a0, a1), = _spans(prof, ("step:augment",))
    assert len(syncs) == want + 2
    assert all(a0 <= s and e <= a1 for _, s, e in syncs)


# --- the readers, on synthetic events ------------------------------------------

def _event(name, start_us, end_us, device, annotation=False):
    from torch.autograd import DeviceType

    tr = type("TR", (), {"start": start_us, "end": end_us})()
    return type("E", (), {"name": name, "time_range": tr, "is_user_annotation": annotation,
                          "device_type": DeviceType.CUDA if device else DeviceType.CPU})()


# device operations (µs): idle gaps [10, 20), [30, 35), [50, 60), [70, 100): 55 µs
KERNELS = [_event("gemm_kernel", 0, 10, True), _event("elementwise_kernel", 20, 30, True),
           _event("attn_fwd_qkv_bf16", 35, 50, True), _event("multi_tensor_apply", 60, 70, True),
           _event("copy_kernel", 100, 110, True), _event("aten::mm", 0, 9, False)]
# the phases hold 10, 10, 5 and 10 µs of idle; 20 µs of [70, 100) lie outside
SPANS = [_event("step:augment", 0, 25, False), _event("sync:h2d", 2, 4, False),
         _event("sync:h2d", 12, 14, False), _event("step:forward", 25, 55, False),
         _event("step:backward", 55, 65, False), _event("step:optimizer", 80, 90, False),
         _event("step:augment", 0, 25, True, annotation=True),
         _event("step:backward", 55, 65, True)]


def _profile(events, steps=1):
    return read_profile(type("P", (), {"events": lambda self: events})(), steps=steps,
                        wall_s=120e-6)


def _read(prof):
    ctx = type("Ctx", (), {"profile": prof})()
    return {name: harness.reader(name).read(ctx) for name in READERS}


def test_idle_is_clipped_to_each_phase():
    got = _read(_profile(KERNELS + SPANS))
    assert got["host_syncs.train"] == 2
    assert got["augment_idle_ms.train"] == pytest.approx(10e-3)
    assert got["forward_idle_ms.train"] == pytest.approx(10e-3)
    assert got["backward_idle_ms.train"] == pytest.approx(5e-3)
    assert got["optimizer_idle_ms.train"] == pytest.approx(10e-3)
    halves = _read(_profile(KERNELS + SPANS, steps=2))
    assert halves["host_syncs.train"] == 1
    assert halves["forward_idle_ms.train"] == pytest.approx(5e-3)


def test_phases_and_the_rest_sum_to_the_idle_between_operations():
    prof = _profile(KERNELS + SPANS)
    phases = [spans.idle_s(prof, (p,)) for p in spans.PHASES]
    rest = spans.between_kernel_idle_s(prof) - spans.idle_s(prof, spans.PHASES)
    assert rest == pytest.approx(20e-6)
    assert sum(phases) + rest == pytest.approx(55e-6)
    assert spans.between_kernel_idle_s(prof) == pytest.approx(
        prof.ends.max() - prof.starts.min() - prof.busy_s())


def test_no_reading_without_the_steps_spans():
    assert _read(_profile(KERNELS)) == dict.fromkeys(READERS)
    assert not spans.recorded(_profile(KERNELS))


def test_spans_leave_the_device_operations_as_they_were():
    plain, spanned = _profile(KERNELS), _profile(KERNELS + SPANS)
    assert spanned.names == plain.names
    assert (spanned.starts == plain.starts).all() and (spanned.ends == plain.ends).all()
    assert spanned.busy_s() == plain.busy_s()
    assert spanned.seconds_by_class() == plain.seconds_by_class()
    # the gaps no host operation spanned are named after the step's phases
    assert dict(plain.idle_gaps(least_s=0)) == {"(no host op)": pytest.approx(55e-6)}
    assert dict(spanned.idle_gaps(least_s=0)) == {
        "step:optimizer": pytest.approx(30e-6), "step:augment": pytest.approx(10e-6),
        "step:backward": pytest.approx(10e-6), "step:forward": pytest.approx(5e-6)}
