"""The port's Mixture-of-Experts layer, model, decoding and serving held to
the JAX package's ``models/moe.py`` and its MoE paths.

Inputs come from numpy with a seed and weights from JAX ``init_params``
through ``params_from_jax``; both packages run on the CPU at a small size
(dim 64, 2 layers, 4 experts, top-2). Tolerances: fp32 outputs and
gradients within 1e-5 of the largest value, the aux loss within 1e-6; the
routing tensors (``eids``, ``rank``, ``valid``) equal exactly; bf16 outputs
fed the same bf16 activations within 2e-2 of the largest value (a bf16 ulp
is 2**-8 of a value, and the expert products sum in another order), with
equal routing. Decoding and serving use the JAX decode tests' limits: 5e-5
for a prefill, 1e-4 for single-token steps, 2e-5 for the paged forward;
greedy tokens equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyrecover_tpu.models.moe as jax_moe
from pyrecover_tpu.config import get_args as jax_get_args
from pyrecover_tpu.metrics import ThroughputMeter as JaxMeter
from pyrecover_tpu.models import presets as jax_presets
from pyrecover_tpu.models.decode import decode_forward as jax_decode_forward
from pyrecover_tpu.models.decode import generate_tokens as jax_generate_tokens
from pyrecover_tpu.models.decode import init_kv_cache as jax_init_kv_cache
from pyrecover_tpu.models.llama import ModelConfig as JaxModelConfig
from pyrecover_tpu.models.llama import forward_hidden_with_aux as jax_hidden_with_aux
from pyrecover_tpu.models.llama import init_params
from pyrecover_tpu.parallel.mesh import MeshConfig, create_mesh
from pyrecover_tpu.serving import kvpool as jax_kvpool
from pyrecover_tpu.serving.paged import paged_forward as jax_paged_forward
from pyrecover_tpu.utils import remat as jax_remat
from pyrecover_tpu_torch.config import get_args
from pyrecover_tpu_torch.metrics import ThroughputMeter
from pyrecover_tpu_torch.models import moe, presets
from pyrecover_tpu_torch.models.decode import decode_forward, generate_tokens, init_kv_cache
from pyrecover_tpu_torch.models.llama import (
    ModelConfig,
    Transformer,
    forward,
    forward_hidden_with_aux,
    layer_keys,
    params_from_jax,
    params_to_numpy,
)
from pyrecover_tpu_torch.serving import BlockPool, ServingConfig, ServingEngine, blocks_for, paged_forward
from pyrecover_tpu_torch.serving.kvpool import make_block_table
from pyrecover_tpu_torch.utils import remat

JCFG = JaxModelConfig().tiny(max_seq_len=32, vocab_size=64, n_experts=4, moe_top_k=2,
                             compute_dtype="float32", param_dtype="float32")
B, S = 2, 16
JAX_BACKENDS = {"grouped": jax_moe._moe_ffn_grouped, "scatter": jax_moe._moe_ffn_impl,
                "einsum": jax_moe._moe_ffn_einsum}


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def port_config(jcfg):
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in dataclasses.asdict(jcfg).items() if k in names})


def layer_inputs(seed=0, zero_router=False, router_scale=0.5):
    """Activations (B, S, D) and one MoE layer's weights, numpy fp32."""
    rng = np.random.default_rng(seed)
    D, E, F = JCFG.dim, JCFG.n_experts, JCFG.expert_hidden_dim
    h = rng.standard_normal((B, S, D)).astype(np.float32)
    router = np.zeros((D, E), np.float32) if zero_router else (
        rng.standard_normal((D, E)) * router_scale).astype(np.float32)
    w1, w3 = ((rng.standard_normal((E, D, F)) * 0.1).astype(np.float32) for _ in range(2))
    w2 = (rng.standard_normal((E, F, D)) * 0.1).astype(np.float32)
    return h, router, w1, w3, w2


def objective(y, aux, r):
    """A scalar that reaches every output element and the aux loss."""
    return (y * r).sum() + aux.sum()


def jax_layer(backend, cfg, arrays, r):
    fn = JAX_BACKENDS[backend]

    def loss(*a):
        y, aux = fn(*a, cfg)
        return objective(y, aux, r), (y, aux)

    (_, (y, aux)), grads = jax.value_and_grad(loss, argnums=tuple(range(5)), has_aux=True)(
        *map(jnp.asarray, arrays))
    return np.asarray(y), np.asarray(aux), [np.asarray(g) for g in grads]


def port_layer(cfg, arrays, r, dtype=torch.float32):
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    h = ts[0].detach().to(dtype).requires_grad_()
    y, aux = moe.moe_ffn(h, *ts[1:], cfg)
    objective(y.float(), aux, torch.from_numpy(r)).backward()
    grads = [h.grad.float()] + [t.grad for t in ts[1:]]
    return y.detach().float().numpy(), aux.detach().numpy(), [g.numpy() for g in grads]


def assert_close_to_max(got, want, rel, what):
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * float(np.abs(want).max()),
                               err_msg=what)


def assert_routing_equal(arrays, jcfg, pcfg, h_dtype=torch.float32):
    E, K = jcfg.n_experts, jcfg.moe_top_k
    C = moe.moe_capacity(S, E, K, jcfg.moe_capacity_factor)
    assert C == jax_moe.moe_capacity(S, E, K, jcfg.moe_capacity_factor)
    h = torch.from_numpy(arrays[0]).to(h_dtype)
    jh = jnp.asarray(h.float().numpy()).astype(jnp.bfloat16 if h_dtype == torch.bfloat16
                                                else jnp.float32)
    j = jax_moe._route(jh, jnp.asarray(arrays[1]), E, K, C)
    p = moe._route(h, torch.from_numpy(arrays[1]), E, K, C)
    for name, i in (("eids", 1), ("onehot", 3), ("rank", 4), ("valid", 5)):
        np.testing.assert_array_equal(p[i].numpy(), np.asarray(j[i]), err_msg=name)
    return p[5].numpy()


# ---- one MoE layer -------------------------------------------------------------


@pytest.mark.parametrize("cf", [1.25, 0.1], ids=["cf1.25", "cf0.1-drops"])
@pytest.mark.parametrize("backend", list(JAX_BACKENDS))
def test_backend_matches_jax(backend, cf):
    """Each backend against the JAX package's same backend, fp32: outputs,
    the aux loss and the gradients of h, router, moe_w1/w3/w2; the routing
    tensors equal. At cf 0.1 the capacity overflows and picks are dropped."""
    jcfg = dataclasses.replace(JCFG, moe_capacity_factor=cf, moe_dispatch=backend)
    pcfg = port_config(jcfg)
    arrays = layer_inputs(seed=1)
    r = np.random.default_rng(2).standard_normal((B, S, JCFG.dim)).astype(np.float32)
    valid = assert_routing_equal(arrays, jcfg, pcfg)
    if cf < 1:
        assert not valid.all()  # capacity overflowed: some picks dropped
    jy, jaux, jg = jax_layer(backend, jcfg, arrays, r)
    py, paux, pg = port_layer(pcfg, arrays, r)
    assert_close_to_max(py, jy, 1e-5, "y")
    np.testing.assert_allclose(paux, jaux, rtol=1e-6)
    for name, a, b in zip(("h", "router", "moe_w1", "moe_w3", "moe_w2"), pg, jg):
        assert_close_to_max(a, b, 1e-5, f"d{name}")


@pytest.mark.parametrize("backend", list(JAX_BACKENDS))
def test_zero_router_ties_go_to_the_lower_index_with_unit_aux(backend):
    """A zero router is all ties: every token picks experts 0 and 1, as
    ``jax.lax.top_k`` breaks ties, and the aux loss is 1 for every row."""
    jcfg = dataclasses.replace(JCFG, moe_dispatch=backend)
    pcfg = port_config(jcfg)
    arrays = layer_inputs(seed=3, zero_router=True)
    assert_routing_equal(arrays, jcfg, pcfg)
    _, eids, *_ = moe._route(torch.from_numpy(arrays[0]), torch.from_numpy(arrays[1]), 4, 2, 8)
    assert (eids.reshape(B, S, 2) == torch.tensor([0, 1])).all()
    r = np.ones((B, S, JCFG.dim), np.float32)
    jy, _, _ = jax_layer(backend, jcfg, arrays, r)
    py, paux, _ = port_layer(pcfg, arrays, r)
    np.testing.assert_allclose(paux, np.ones(B), rtol=1e-6)
    assert_close_to_max(py, jy, 1e-5, "y")


@pytest.mark.parametrize("cf", [1.25, 0.1], ids=["cf1.25", "cf0.1-drops"])
def test_backends_equal_each_other(cf):
    """grouped, scatter and einsum compute one function: fp32 outputs, aux
    and gradients within 1e-6 of the largest value."""
    arrays = layer_inputs(seed=4)
    r = np.random.default_rng(5).standard_normal((B, S, JCFG.dim)).astype(np.float32)
    runs = {b: port_layer(port_config(dataclasses.replace(JCFG, moe_capacity_factor=cf,
                                                           moe_dispatch=b)), arrays, r)
            for b in moe.DISPATCH_BACKENDS}
    ref = runs["grouped"]
    for b in ("scatter", "einsum"):
        y, aux, grads = runs[b]
        assert_close_to_max(y, ref[0], 1e-6, f"{b} y")
        np.testing.assert_allclose(aux, ref[1], rtol=1e-6)
        for g, gr in zip(grads, ref[2]):
            assert_close_to_max(g, gr, 1e-6, f"{b} grad")


@pytest.mark.parametrize("backend", list(JAX_BACKENDS))
def test_bf16_activations_route_as_jax(backend):
    """bf16 compute: both packages take the same bf16 h (the router upcasts
    it), so the routing is equal and the outputs agree within bf16
    rounding."""
    jcfg = dataclasses.replace(JCFG, moe_dispatch=backend, compute_dtype="bfloat16")
    pcfg = port_config(jcfg)
    arrays = layer_inputs(seed=6)
    h16 = torch.from_numpy(arrays[0]).bfloat16()
    assert_routing_equal(arrays, jcfg, pcfg, torch.bfloat16)
    jh = jnp.asarray(h16.float().numpy()).astype(jnp.bfloat16)
    jy, jaux = JAX_BACKENDS[backend](jh, *map(jnp.asarray, arrays[1:]), jcfg)
    py, paux = moe.moe_ffn(h16, *map(torch.from_numpy, arrays[1:]), pcfg)
    assert py.dtype == torch.bfloat16
    jy = np.asarray(jy.astype(jnp.float32))
    assert_close_to_max(py.float().numpy(), jy, 2e-2, "y")
    np.testing.assert_allclose(paux.numpy(), np.asarray(jaux), rtol=1e-6)


def test_auto_pick_matches_jax_at_ep1(monkeypatch, devices8):
    """``auto`` is JAX's pick at ep 1: ``_moe_ffn_grouped`` on an unsharded
    batch. On a data-sharded batch JAX picks ``_moe_ffn_grouped_ep``, whose
    sort stays on each shard; over a shard's rows that is the port's
    ``grouped`` on those rows, what each data-parallel rank runs."""
    calls = []
    for name in ("_moe_ffn_grouped", "_moe_ffn_grouped_ep", "_moe_ffn_impl", "_moe_ffn_einsum"):
        real = getattr(jax_moe, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*a, **kw)

        monkeypatch.setattr(jax_moe, name, spy)
    pcfg = port_config(JCFG)
    assert pcfg.moe_dispatch == JCFG.moe_dispatch == "auto"
    # at fp32 the port's pick is scatter (the same function; fp32 grouped
    # products read their offsets on the host on the card), grouped otherwise
    assert moe.dispatch_backend(pcfg) == "scatter"
    assert moe.dispatch_backend(dataclasses.replace(pcfg, compute_dtype="bfloat16")) == "grouped"
    arrays = layer_inputs(seed=7)
    args = [jnp.asarray(a) for a in arrays]
    y1, aux1 = jax_moe.moe_ffn(*args, JCFG)
    assert calls == ["_moe_ffn_grouped"]
    calls.clear()
    mesh = create_mesh(MeshConfig(data=2), devices=devices8[:2])
    with jax.sharding.set_mesh(mesh):
        y2, aux2 = jax.jit(lambda *a: jax_moe.moe_ffn(*a, JCFG))(*args)
    assert calls == ["_moe_ffn_grouped_ep"]
    halves = [moe.moe_ffn(torch.from_numpy(arrays[0][i:i + 1]),
                          *map(torch.from_numpy, arrays[1:]), pcfg) for i in range(B)]
    py = torch.cat([y for y, _ in halves]).numpy()
    paux = torch.cat([a for _, a in halves]).numpy()
    for jy, jaux in ((y1, aux1), (y2, aux2)):
        assert_close_to_max(py, np.asarray(jy), 1e-5, "y")
        np.testing.assert_allclose(paux, np.asarray(jaux), rtol=1e-6)
    with pytest.raises(ValueError, match="moe_dispatch"):
        moe.dispatch_backend(dataclasses.replace(pcfg, moe_dispatch="ring"))


@pytest.mark.parametrize("dtype,backend", [("float32", "scatter"), ("bfloat16", "grouped"),
                                           ("float16", "grouped")])
def test_auto_pick_by_compute_dtype(dtype, backend, monkeypatch):
    """``auto`` runs ``scatter`` at fp32 compute and ``grouped`` otherwise; an
    explicit backend is kept at every dtype. At fp32 the auto layer equals
    the grouped one (one function, summed in another order)."""
    pcfg = dataclasses.replace(port_config(JCFG), compute_dtype=dtype)
    assert moe.dispatch_backend(pcfg) == backend
    for name in moe.DISPATCH_BACKENDS:
        assert moe.dispatch_backend(dataclasses.replace(pcfg, moe_dispatch=name)) == name
    if dtype != "float32":
        return
    calls = []
    real = moe._BACKENDS["scatter"]
    monkeypatch.setitem(moe._BACKENDS, "scatter",
                        lambda *a, **k: calls.append("scatter") or real(*a, **k))
    args = [torch.from_numpy(a) for a in layer_inputs(seed=3)]
    y_auto, aux_auto = moe.moe_ffn(*args, pcfg)
    y_grouped, aux_grouped = moe.moe_ffn(*args, dataclasses.replace(pcfg, moe_dispatch="grouped"))
    assert calls == ["scatter"]
    assert_close_to_max(y_auto.numpy(), y_grouped.numpy(), 1e-6, "y")
    np.testing.assert_allclose(aux_auto.numpy(), aux_grouped.numpy(), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_auto_pick_at_no_drop(dtype, monkeypatch):
    """At the no-drop capacity (cf = E, what decode and paged serving route
    with) ``auto`` picks by the compute dtype alone, as below it: ``scatter``
    at fp32, whose layer there equals ``grouped``'s, and ``grouped``
    otherwise."""
    pcfg = dataclasses.replace(no_drop(port_config(JCFG)), compute_dtype=dtype)
    assert pcfg.moe_capacity_factor == pcfg.n_experts
    want = "scatter" if dtype == "float32" else "grouped"
    assert moe.dispatch_backend(pcfg) == want
    if dtype != "float32":
        return
    calls = []
    real = moe._BACKENDS["scatter"]
    monkeypatch.setitem(moe._BACKENDS, "scatter",
                        lambda *a, **k: calls.append("scatter") or real(*a, **k))
    args = [torch.from_numpy(a) for a in layer_inputs(seed=4)]
    y_auto, aux_auto = moe.moe_ffn(*args, pcfg)
    y_grouped, aux_grouped = moe.moe_ffn(*args, dataclasses.replace(pcfg, moe_dispatch="grouped"))
    assert calls == ["scatter"]
    assert_close_to_max(y_auto.numpy(), y_grouped.numpy(), 1e-6, "y")
    np.testing.assert_allclose(aux_auto.numpy(), aux_grouped.numpy(), rtol=1e-6)


# ---- the MoE model -------------------------------------------------------------


def model_pair(jcfg=JCFG, seed=0):
    np_params = jax.tree.map(np.asarray, init_params(jax.random.key(seed), jcfg))
    model = Transformer(port_config(jcfg))
    model.load_state_dict(params_from_jax(np_params))
    return np_params, model


def tokens(b, s, seed=0, vocab=JCFG.vocab_size):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


REMAT = {"none": dict(remat=False), "save-attn": dict(remat=True, remat_policy="save-attn"),
         "full": dict(remat=True, remat_policy="full")}


@pytest.mark.parametrize("policy", list(REMAT))
def test_moe_model_matches_jax_under_remat(policy):
    """``forward_hidden_with_aux`` of the MoE model against JAX's, under each
    remat policy: the hidden states, the aux loss (summed over the layers,
    the mean over the rows) and the gradients of every parameter through
    both, so the aux leaves each rematerialized region intact."""
    jcfg = dataclasses.replace(JCFG, **REMAT[policy])
    np_params, model = model_pair(jcfg)
    toks = tokens(B, S, seed=8)
    r = np.random.default_rng(9).standard_normal((B, S, jcfg.dim)).astype(np.float32)

    def jloss(p):
        hidden, aux = jax_hidden_with_aux(p, jnp.asarray(toks), jcfg)
        return (hidden * r).sum() + aux, (hidden, aux)

    (_, (jh, jaux)), jg = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree.map(jnp.asarray, np_params))
    hidden, aux = forward_hidden_with_aux(model, torch.from_numpy(toks).long())
    ((hidden * torch.from_numpy(r)).sum() + aux).backward()
    aux = float(aux.detach())
    assert_close_to_max(hidden.detach().numpy(), np.asarray(jh), 1e-5, "hidden")
    np.testing.assert_allclose(aux, float(jaux), rtol=1e-6)
    assert 1.0 < aux < jcfg.n_layers * jcfg.n_experts  # ~1 a layer near a uniform router
    grads = {n: p.grad for n, p in model.named_parameters()}
    for key, want in jax.tree.map(np.asarray, jg)["layers"].items():
        got = np.stack([grads[f"layers.{i}.{key}"].numpy() for i in range(jcfg.n_layers)])
        assert_close_to_max(got, want, 1e-5, key)


def test_moe_leaves_and_param_bridge():
    """The MoE block's leaves are JAX's, the router fp32 under bf16
    parameters, and ``params_to_numpy`` inverts ``params_from_jax``."""
    jcfg = dataclasses.replace(JCFG, param_dtype="bfloat16")
    np_params, model = model_pair(jcfg)
    assert sorted(layer_keys(model.config)) == sorted(np_params["layers"])
    assert "w1" not in dict(model.layers[0].named_parameters())
    assert model.layers[0].router.dtype == torch.float32
    assert model.layers[0].moe_w1.dtype == torch.bfloat16
    assert np_params["layers"]["router"].dtype == np.float32
    back = params_to_numpy(model)
    for key, want in np_params["layers"].items():
        np.testing.assert_array_equal(back["layers"][key], np.asarray(want, np.float32), key)
    with pytest.raises(ValueError, match="moe_top_k"):
        ModelConfig(n_experts=2, moe_top_k=3)


# ---- presets, counts, flags ----------------------------------------------------


@pytest.mark.parametrize("name", list(jax_presets.PRESETS))
def test_presets_and_counts_match_jax(name):
    cfg, jcfg = presets.PRESETS[name](), jax_presets.PRESETS[name]()
    assert cfg == port_config(jcfg)
    assert presets.analytic_param_count(cfg) == jax_presets.analytic_param_count(jcfg)
    for ex in (False, True):
        assert (presets.analytic_active_param_count(cfg, exclude_embedding=ex)
                == jax_presets.analytic_active_param_count(jcfg, exclude_embedding=ex))
    assert (presets.inactive_expert_param_count(cfg)
            == jax_presets.inactive_expert_param_count(jcfg))
    if name == "moe-4x1b":
        assert presets.analytic_param_count(cfg) == 1_644_267_520
        assert presets.analytic_active_param_count(cfg) == 939_624_448
    # MFU over the active parameters, as the JAX meter counts them
    n = presets.analytic_param_count(cfg, exclude_embedding=True)
    assert (ThroughputMeter(cfg, n, 1024, None).flop_per_token
            == JaxMeter(jcfg, n, 1024).flop_per_token)


@pytest.mark.parametrize("dtypes", [{}, {"param_dtype": "bfloat16"}], ids=["fp32", "bf16-params"])
def test_remat_byte_model_counts_the_experts(dtypes):
    """The remat byte model of an MoE model equals JAX's SC05 table, its
    parameter count is the model's, and its parameter bytes hold the fp32
    router."""
    shape = dict(dim=2048, n_layers=8, n_heads=16, n_kv_heads=8, vocab_size=32768,
                 n_experts=4, moe_top_k=2)
    cfg, jcfg = ModelConfig(**shape, **dtypes), JaxModelConfig(**shape, **dtypes)
    for policy, _, _ in remat.REMAT_POLICIES:
        got = remat.modelled_total_bytes(cfg, batch_size=4, seq_len=1024, policy=policy)
        want = jax_remat.modelled_total_bytes(jcfg, {}, batch_size=4, seq_len=1024,
                                              policy=policy)
        assert got == want, (policy, got, want)
    params = list(Transformer(cfg, device="meta").parameters())
    assert remat.param_count(cfg) == sum(p.numel() for p in params)
    assert remat.param_bytes(cfg) == sum(p.numel() * p.element_size() for p in params)


def test_moe_flags_match_jax():
    argv = ["--moe-experts", "4", "--moe-top-k", "1", "--moe-capacity-factor", "2.0",
            "--moe-aux-weight", "0.05"]
    fields = ("n_experts", "moe_top_k", "moe_capacity_factor", "moe_aux_weight",
              "moe_ffn_hidden", "moe_dispatch")
    for args in ([], argv):
        got, want = get_args(args + ["--device", "cpu"]).model, jax_get_args(args).model
        assert {f: getattr(got, f) for f in fields} == {f: getattr(want, f) for f in fields}


# ---- decoding and serving ------------------------------------------------------


def no_drop(cfg):
    return dataclasses.replace(cfg, moe_capacity_factor=float(cfg.n_experts))


def test_moe_decode_matches_forward_and_jax():
    """A 4-token prefill and single-token steps: the port's cached decode,
    which routes with no drops whatever the model's capacity factor, equals
    the training forward at the no-drop capacity and JAX's
    ``decode_forward``."""
    np_params, model = model_pair()
    assert model.config.moe_capacity_factor == 1.25
    toks = tokens(2, 10, seed=10)
    ref_model = Transformer(no_drop(model.config))
    ref_model.load_state_dict(model.state_dict())
    with torch.no_grad():
        ref = forward(ref_model, torch.from_numpy(toks).long()).numpy()
    params = jax.tree.map(jnp.asarray, np_params)
    jstep = jax.jit(lambda p, c, t, pos: jax_decode_forward(p, c, t, pos, JCFG))
    jcache = jax_init_kv_cache(JCFG, 2, JCFG.max_seq_len)
    cache = init_kv_cache(model.config, 2, JCFG.max_seq_len, device="cpu")
    got = decode_forward(model, cache, torch.from_numpy(toks[:, :4]).long(), 0).numpy()
    want, jcache = jstep(params, jcache, jnp.asarray(toks[:, :4]), 0)
    np.testing.assert_allclose(got, ref[:, :4], rtol=5e-5, atol=5e-5)
    np.testing.assert_allclose(got, np.asarray(want), rtol=5e-5, atol=5e-5)
    for pos in range(4, toks.shape[1]):
        got = decode_forward(model, cache, torch.from_numpy(toks[:, pos:pos + 1]).long(), pos)
        want, jcache = jstep(params, jcache, jnp.asarray(toks[:, pos:pos + 1]), pos)
        np.testing.assert_allclose(got[:, 0].numpy(), ref[:, pos], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got[:, 0].numpy(), np.asarray(want[:, 0]), rtol=1e-4,
                                   atol=1e-4)


def test_moe_paged_forward_matches_jax():
    """The paged forward of the MoE model against JAX's on the same pool
    layout: two sequences prefilled in chunks of 8, then one decode step of
    both beside an inactive row; and the chunked prefill against the
    training forward at the no-drop capacity."""
    np_params, model = model_pair(seed=1)
    params = jax.tree.map(jnp.asarray, np_params)
    jpool = jax_kvpool.BlockPool(JCFG, n_blocks=12, block_size=8)
    pool = BlockPool(model.config, n_blocks=12, block_size=8, device="cpu")
    width = pool.table_width(JCFG.max_seq_len)
    lens = [13, 6]
    prompts = [tokens(1, n, seed=11 + i)[0].tolist() for i, n in enumerate(lens)]
    tables = np.stack([make_block_table(width, pool.alloc(i, blocks_for(n + 2, 8)))
                       for i, n in enumerate(lens)] + [make_block_table(width)])
    for i, n in enumerate(lens):
        jpool.alloc(i, blocks_for(n + 2, 8))
    jarrays = jpool.arrays
    logits = {}

    def both(toks, pos, tbl):
        nonlocal jarrays
        want, jarrays = jax_paged_forward(params, jarrays, jnp.asarray(toks, jnp.int32),
                                          jnp.asarray(pos, jnp.int32), jnp.asarray(tbl), JCFG,
                                          block_size=8)
        got = paged_forward(model, pool.arrays, np.asarray(toks), pos, tbl, block_size=8)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
        return got

    for i, prompt in enumerate(prompts):
        padded = prompt + [0] * (-len(prompt) % 8)
        logits[i] = torch.cat([both([padded[s0:s0 + 8]], [s0], tables[i:i + 1])[0]
                               for s0 in range(0, len(padded), 8)])[:len(prompt)]
    both([[p[-1]] for p in prompts] + [[0]], lens + [0], tables)
    ref_model = Transformer(no_drop(model.config))
    ref_model.load_state_dict(model.state_dict())
    for i, prompt in enumerate(prompts):
        with torch.no_grad():
            ref = forward(ref_model, torch.tensor([prompt]))[0]
        np.testing.assert_allclose(logits[i].numpy(), ref.numpy(), rtol=2e-5, atol=2e-5)


def test_moe_engine_greedy_equals_generate_tokens():
    """Greedy decoding of ragged requests through the serving engine equals
    the port's and JAX's lockstep ``generate_tokens``, token for token; the
    pool drains."""
    np_params, model = model_pair(seed=2)
    params = jax.tree.map(jnp.asarray, np_params)
    engine = ServingEngine(model, ServingConfig(block_size=8, max_seqs=3, prefill_chunk=8,
                                                prefill_token_budget=16))
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, JCFG.vocab_size, (int(n),)).tolist() for n in (3, 9, 14, 5)]
    news = [6, 4, 8, 5]
    rids = [engine.submit(p, n) for p, n in zip(prompts, news)]
    engine.run_until_drained()
    for rid, p, n in zip(rids, prompts, news):
        got = engine.result(rid)
        assert got == generate_tokens(model, p, n), rid
        assert got == jax_generate_tokens(params, JCFG, p, n), rid
    engine.pool.check_drained()
