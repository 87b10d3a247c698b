"""The port's MoE FFN (``cross_attention_vit_tpu_torch/parallel/moe.py``)
against the JAX package's ``parallel/moe.py`` — the counterpart of
``tests/test_moe.py`` — on the same numpy inputs, with JAX's weights
carried across.

* Routing: the dispatch and combine masks built from the port's ``route``
  equal JAX's exactly (top-1 and top-2, ties, capacity overflow); the
  balance loss and dispatch fraction too.
* ``moe_ffn``: forward and the gradients of every weight and of the input
  within 1e-5 of JAX's (f32); an E = 1 MoE is the dense FFN.
* Expert parallelism over gloo ranks (``tests/torch_mesh_workers.py``):
  (expert 2) at world 2 and (data 2 × expert 2) at world 4, top-1 and top-2,
  each rank holding E/2 experts: outputs and every gradient within 1e-5 of
  the one-process port's on the whole batch (capacity factor 2, so no
  choice is dropped; the data axis routes the global batch, as JAX does).
* Placement: split experts on 'expert', the router whole, and the FSDP rule
  over MoE models equal to JAX's ``param_specs(fsdp=True)``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cross_attention_vit_tpu.parallel import moe as jmoe
from cross_attention_vit_tpu_torch.parallel import moe as tmoe
from torch_mesh_workers import (EXPERTS, HIDDEN, MLP, MOE_CAPACITY_FACTOR,
                                dispatch_combine_masks, load, port_config, spawn)

TOL = 1e-5


def _tokens(key, batch=4, n=10, hidden=HIDDEN):
    return np.asarray(jax.random.normal(key, (batch, n, hidden), jnp.float32))


def _port_state(params) -> dict[str, np.ndarray]:
    """A JAX ``init_moe_ffn`` tree as a ``MoEFFN`` state dict."""
    swap = lambda w: np.ascontiguousarray(np.swapaxes(np.asarray(w), 1, 2))  # noqa: E731
    e = params["experts"]
    return {"router.weight": np.ascontiguousarray(np.asarray(params["router"]["kernel"]).T),
            "experts.fc1.weight": swap(e["fc1"]["kernel"]),
            "experts.fc1.bias": np.asarray(e["fc1"]["bias"]),
            "experts.fc2.weight": swap(e["fc2"]["kernel"]),
            "experts.fc2.bias": np.asarray(e["fc2"]["bias"])}


def _port_site(params, num_selected, capacity_factor=1.25) -> tmoe.MoEFFN:
    state = _port_state(params)
    site = tmoe.MoEFFN(HIDDEN, MLP, state["router.weight"].shape[0], num_selected,
                       capacity_factor)
    site.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return site


def _jax_grads(params, x, k, cf):
    """JAX's loss Σ tanh(y) + 0.01·balance: (y, aux, grads as a port state
    dict, dx)."""
    def loss(p, x):
        y, aux = jmoe.moe_ffn(p, x, num_selected=k, capacity_factor=cf)
        return jnp.sum(jnp.tanh(y)) + 0.01 * aux["balance_loss"], (y, aux)

    (_, (y, aux)), (g, dx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(params, x)
    return np.asarray(y), aux, _port_state(g), np.asarray(dx)


def _port_grads(params, x, k, cf):
    site = _port_site(params, k, cf)
    xt = torch.tensor(x, requires_grad=True)
    y, aux = site(xt)
    (torch.tanh(y).sum() + 0.01 * aux["balance_loss"]).backward()
    return (y.detach().numpy(), aux, {n: p.grad.numpy() for n, p in site.named_parameters()},
            xt.grad.numpy())


def test_e1_equals_dense_ffn():
    """A 1-expert MoE with enough capacity is exactly fc1/GELU/fc2, and
    JAX's."""
    params = jmoe.init_moe_ffn(jax.random.key(0), HIDDEN, MLP, num_experts=1)
    x = _tokens(jax.random.key(1))
    y, aux = _port_site(params, 1, 1.0)(torch.from_numpy(x))
    e = {k: torch.from_numpy(v) for k, v in _port_state(params).items()}
    xt = torch.from_numpy(x)
    h = torch.nn.functional.gelu(xt @ e["experts.fc1.weight"][0].T + e["experts.fc1.bias"][0])
    dense = h @ e["experts.fc2.weight"][0].T + e["experts.fc2.bias"][0]
    torch.testing.assert_close(y, dense, atol=1e-6, rtol=1e-6)
    want, jaux = jmoe.moe_ffn(params, x, num_selected=1, capacity_factor=1.0)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    assert float(aux["dispatch_fraction"]) == float(jaux["dispatch_fraction"]) == 1.0


@pytest.mark.parametrize("num_selected", [1, 2])
def test_moe_matches_jax(num_selected):
    """Forward, balance loss, dispatch fraction and the gradients of every
    weight and of the input, against JAX's, with choices dropped
    (capacity factor 1)."""
    params = jmoe.init_moe_ffn(jax.random.key(0), HIDDEN, MLP, EXPERTS)
    x = _tokens(jax.random.key(1))
    y, aux, grads, dx = _port_grads(params, x, num_selected, 1.0)
    wy, waux, wgrads, wdx = _jax_grads(params, x, num_selected, 1.0)
    assert float(waux["dispatch_fraction"]) < 1.0          # the capacity bound
    np.testing.assert_allclose(y, wy, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(dx, wdx, atol=TOL, rtol=TOL)
    assert abs(float(aux["balance_loss"].detach()) - float(waux["balance_loss"])) <= TOL
    assert float(aux["dispatch_fraction"]) == pytest.approx(float(waux["dispatch_fraction"]))
    assert set(grads) == set(wgrads)
    for n in grads:
        np.testing.assert_allclose(grads[n], wgrads[n], atol=TOL, rtol=TOL, err_msg=n)


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """The port's MoE over gloo ranks: (expert 2) and (data 2, expert 2)."""
    tmp = tmp_path_factory.mktemp("moe")
    params = jmoe.init_moe_ffn(jax.random.key(0), HIDDEN, MLP, EXPERTS)
    x = _tokens(jax.random.key(1), batch=8)
    np.savez(tmp / "moe.npz", x=x, **_port_state(params))
    for world in (2, 4):
        spawn("moe", tmp, world)
    return params, x, {w: load(tmp, f"moe_w{w}", w) for w in (2, 4)}


@pytest.mark.parametrize("world", [2, 4], ids=["expert2", "data2_expert2"])
@pytest.mark.parametrize("num_selected", [1, 2])
def test_ep_sharded_matches_serial(sharded, num_selected, world):
    """Each rank's rows of the output (bit for bit) and of the input's
    gradient, the balance loss, the dispatch fraction and every weight's
    gradient (the split experts gathered) against the one-process port on
    the whole batch; the ranks of a data coordinate agree exactly."""
    params, x, runs = sharded
    y, aux, grads, dx = _port_grads(params, x, num_selected, MOE_CAPACITY_FACTOR)
    k = f"k{num_selected}"
    ranks = runs[world]
    rows = len(x) // (world // 2)
    for r, got in enumerate(ranks):
        d = r // 2
        # each expert's GEMMs take one shape whatever the split: the same bits
        np.testing.assert_array_equal(got[f"{k}/y"], y[d * rows:(d + 1) * rows])
        np.testing.assert_allclose(got[f"{k}/dx"], dx[d * rows:(d + 1) * rows], atol=TOL,
                                   rtol=TOL)
        assert abs(float(got[f"{k}/balance"]) - float(aux["balance_loss"])) <= TOL
        assert float(got[f"{k}/dispatch_fraction"]) == float(aux["dispatch_fraction"]) == 1.0
        for n, g in grads.items():
            np.testing.assert_allclose(got[f"{k}/grad/{n}"], g, atol=TOL, rtol=TOL, err_msg=n)
        peer = ranks[r ^ 1]
        np.testing.assert_array_equal(got[f"{k}/y"], peer[f"{k}/y"])


def test_shard_experts_splits_the_experts_and_keeps_the_router(sharded):
    """Each rank of an expert line of 2 holds its half of every expert stack
    (the JAX ``P('expert', None, None)``), the router whole."""
    params, _, runs = sharded
    whole = _port_state(params)["experts.fc1.weight"]
    for world, ranks in runs.items():
        for r, got in enumerate(ranks):
            e = r % 2
            assert list(got["layout"]) == [EXPERTS // 2, EXPERTS]
            np.testing.assert_array_equal(got["fc1_local"], whole[e * 2:(e + 1) * 2])


def test_capacity_overflow_drops_tokens():
    """Every token routed to expert 0 with capacity for only some: the
    overflowing tokens' outputs are 0 and the dispatch fraction reports the
    drop, as in JAX."""
    params = jmoe.init_moe_ffn(jax.random.key(0), HIDDEN, MLP, EXPERTS)
    kernel = np.zeros((HIDDEN, EXPERTS), np.float32)
    kernel[:, 0] = 1.0
    params["router"]["kernel"] = jnp.asarray(kernel)
    x = np.abs(_tokens(jax.random.key(1), batch=1, n=16)) + 0.1
    y, aux = _port_site(params, 1, 1.0)(torch.from_numpy(x))
    cap = tmoe.expert_capacity(16, EXPERTS, 1, 1.0)
    assert cap == jmoe.expert_capacity(16, EXPERTS, 1, 1.0) == 4
    flat = y.detach().numpy().reshape(16, HIDDEN)
    assert np.all(flat[cap:] == 0.0) and np.any(flat[:cap] != 0.0)
    assert float(aux["dispatch_fraction"]) == pytest.approx(cap / 16)
    want, _ = jmoe.moe_ffn(params, x, num_selected=1, capacity_factor=1.0)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_balance_loss_uniform_routing_is_one():
    """Zero router weights: uniform probabilities, all ties, which the
    stable sort breaks toward the lower expert as ``lax.top_k`` does — the
    same slots as JAX and a balance loss of 1."""
    params = jmoe.init_moe_ffn(jax.random.key(0), HIDDEN, MLP, num_experts=8)
    params["router"]["kernel"] = jnp.zeros_like(params["router"]["kernel"])
    _, aux = _port_site(params, 2)(torch.from_numpy(_tokens(jax.random.key(1))))
    assert float(aux["balance_loss"]) == pytest.approx(1.0, rel=1e-6)
    probs = np.full((40, 8), 1 / 8, np.float32)
    d, c, b = dispatch_combine_masks(torch.from_numpy(probs), 2, 12)
    wd, wc, wb = jmoe._dispatch_combine(jnp.asarray(probs), 2, 12)
    np.testing.assert_array_equal(d.numpy(), np.asarray(wd))
    np.testing.assert_array_equal(c.numpy(), np.asarray(wc))


@pytest.mark.parametrize("capacity", [32, 5])
def test_top2_gates_normalized(capacity):
    """The dispatch and combine masks equal JAX's exactly, top-1 and top-2;
    with room for every choice the top-2 combine weights sum to 1 per token
    and the top-1 weight is the raw probability."""
    probs = np.asarray(jax.nn.softmax(jax.random.normal(jax.random.key(0), (32, 8)), axis=-1))
    for k in (1, 2):
        d, c, b = dispatch_combine_masks(torch.from_numpy(probs), k, capacity)
        wd, wc, wb = jmoe._dispatch_combine(jnp.asarray(probs), k, capacity)
        np.testing.assert_array_equal(d.numpy(), np.asarray(wd))
        np.testing.assert_array_equal(c.numpy(), np.asarray(wc))
        assert abs(float(b) - float(wb)) <= 1e-6
    if capacity == 32:
        _, c2, _ = dispatch_combine_masks(torch.from_numpy(probs), 2, capacity)
        np.testing.assert_allclose(c2.sum(dim=(1, 2)).numpy(), 1.0, rtol=1e-6)
        _, c1, _ = dispatch_combine_masks(torch.from_numpy(probs), 1, capacity)
        np.testing.assert_allclose(c1.sum(dim=(1, 2)).numpy(), probs.max(-1), rtol=1e-6)


@pytest.mark.parametrize("family", ["cross", "vit"])
@pytest.mark.parametrize("data_size", [2, 4])
def test_fsdp_rule_leaves_the_expert_axis(family, data_size):
    """In a MoE model the FSDP rule shards exactly the parameters JAX's
    ``param_specs(fsdp=True)`` marks with 'data' (never on an expert stack's
    E axis, which JAX gives 'expert'; the router by the generic rule)."""
    from jax.sharding import PartitionSpec as P

    from cross_attention_vit_tpu.parallel.sharding import param_specs
    from cross_attention_vit_tpu_torch.models.convert import (jax_params_from_model,
                                                              state_dict_from_jax)
    from cross_attention_vit_tpu_torch.models.model_cross import ModelCross
    from cross_attention_vit_tpu_torch.models.model_vit import ModelVIT
    from cross_attention_vit_tpu_torch.parallel import fsdp_dim

    cfg = port_config(family, moe_experts=4, hidden_dim=64, mlp_dim=1024)
    model = (ModelCross if family == "cross" else ModelVIT)(cfg, device="cpu",
                                                            master_weights=True)
    tree = jax_params_from_model(model)
    specs = param_specs(tree, fsdp=True, data_size=data_size)
    leaf = tree["layers"][0] if family == "vit" else tree["multi_blocks"][0]["self_blocks"][0][0]
    spec = specs["layers"][0] if family == "vit" else specs["multi_blocks"][0]["self_blocks"][0][0]
    assert spec["ffn"]["experts"]["fc1"]["kernel"][0] == "expert"
    assert leaf["ffn"]["router"]["kernel"].shape == (64, 4)
    marks = jax.tree.map(lambda a, s: np.full(a.shape, float("data" in s), np.float32),
                         tree, specs, is_leaf=lambda x: isinstance(x, P))
    want = {k for k, v in state_dict_from_jax(marks, cfg).items() if v.all()}
    dims = {n: fsdp_dim(n, tuple(p.shape), cfg.num_heads, data_size)
            for n, p in model.named_parameters()}
    assert {n for n, d in dims.items() if d is not None} == want
    assert any(".experts." in n for n in want)
    for n in want:
        assert dims[n] != 0 or ".experts." not in n


def test_grads_finite_through_router():
    """Top-k is piecewise constant, but the combine weights carry gradient
    into the router; everything stays finite."""
    params = jmoe.init_moe_ffn(jax.random.key(0), HIDDEN, MLP, EXPERTS)
    site = _port_site(params, 2)
    y, aux = site(torch.from_numpy(_tokens(jax.random.key(1))))
    ((y ** 2).sum() + 0.01 * aux["balance_loss"]).backward()
    assert all(torch.isfinite(p.grad).all() for p in site.parameters())
    assert site.router.weight.grad.abs().sum() > 0
