"""The port's MoE feed-forward and MoE serving path against the reference,
on ``reduced()`` configs in float32 with the reference's weights carried
across by ``convert``.

``moe_apply``: the top-k experts of every token equal, the capacity
dispatch (which (token, choice) pairs keep a slot and which slot) equal bit
for bit, the output within 2e-5 and the aux loss within 1e-6, at the
config's capacity factor and at one that drops most pairs.  The whole path
(olmoe-1b-7b, grok-1-314b): prefill logits and every layer's KV cache within
2e-5 with a prompt past ``attn_chunk`` (the blocked branch, through the
flash kernel's plain version), then three greedy decode steps continuing
from the prefill's caches, logits within 2e-5 and tokens equal.  A near tie
in a router's gates would be reported by the index check, not hidden.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import models as jmodels  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.attention import KVCache as JKVCache  # noqa: E402
from repro_torch import configs, models  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.models import moe  # noqa: E402

TOL = 2e-5


def _cfgs(name, **changes):
    return (dataclasses.replace(jconfigs.get_arch(name).reduced(), **changes),
            dataclasses.replace(configs.get_arch(name).reduced(), **changes))


@pytest.mark.parametrize("capacity_factor", [1.25, 0.25])
def test_moe_apply_matches(capacity_factor):
    cfg_j, cfg = _cfgs("olmoe-1b-7b", capacity_factor=capacity_factor)
    p_j, _ = jmoe.init_moe(jax.random.key(5), cfg_j)
    p = {k: torch.as_tensor(np.array(v)) for k, v in p_j.items()}
    # two chunks of moe_chunk tokens
    x = np.random.default_rng(7).normal(size=(2, 2 * cfg.moe_chunk, cfg.d_model))
    x = x.astype(np.float32)
    drops = 0
    for c0 in range(0, x.shape[1], cfg.moe_chunk):
        xc = x[:, c0 : c0 + cfg.moe_chunk]
        comb_j, disp_j, aux_j = jmoe._route(p_j, cfg_j, jnp.asarray(xc))
        comb, disp, aux = moe._route(p, cfg, torch.as_tensor(xc))
        # the top-k experts of every token, each package's own softmax and top-k
        gates_j = jax.nn.softmax(jnp.asarray(xc) @ p_j["router"], axis=-1)
        gates = torch.softmax(torch.as_tensor(xc) @ p["router"], dim=-1)
        np.testing.assert_array_equal(torch.topk(gates, cfg.top_k).indices.numpy(),
                                      np.asarray(jax.lax.top_k(gates_j, cfg.top_k)[1]))
        # the same pairs keep the same slots; the same pairs are dropped
        np.testing.assert_array_equal(disp.numpy(), np.asarray(disp_j))
        np.testing.assert_allclose(comb.numpy(), np.asarray(comb_j), rtol=0, atol=1e-6)
        np.testing.assert_allclose(float(aux), float(aux_j), rtol=0, atol=1e-6)
        drops += xc.shape[0] * xc.shape[1] * cfg.top_k - int(disp.sum())
    if capacity_factor < 1:
        assert drops > 0  # the small buffers overflow
    y_j, aux_j = jmoe.moe_apply(p_j, cfg_j, jnp.asarray(x))
    y, aux = moe.moe_apply(p, cfg, torch.as_tensor(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), rtol=0, atol=TOL)
    np.testing.assert_allclose(float(aux), float(aux_j), rtol=0, atol=1e-6)


def _pad_kv_j(cache, length):
    """A reference prefill's (k, v) of stacked [units, B, S, ...] as the
    decode's KVCache of ``length`` positions."""
    return JKVCache(*(jnp.pad(a, [(0, 0), (0, 0), (0, length - a.shape[2])]
                              + [(0, 0)] * (a.ndim - 3)) for a in cache))


def _pad_kv(cache, length):
    return type(cache)(*(torch.nn.functional.pad(a, (0, 0, 0, 0, 0, length - a.shape[1]))
                         for a in cache))


def check_lm_path(name: str, S: int = 96, steps: int = 3) -> None:
    """Prefill of a [2, S] prompt and ``steps`` greedy decode steps after it,
    both packages on the reference's weights (key 0).  Each layer's cache is
    a KVCache or an SSMCache by the config's layer pattern; the decode
    caches are the prefill's, the KV caches padded to S + steps."""
    cfg_j, cfg = _cfgs(name)
    assert S > cfg.attn_chunk
    api_j, api = jmodels.build(cfg_j), models.build(cfg)
    params_j, _ = api_j.init(jax.random.key(0))
    params = lm_params_from_numpy(jax.tree.map(np.asarray, params_j), cfg, "cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, S))
    logits_j, caches_j = jax.jit(api_j.prefill)(params_j, jnp.asarray(toks, jnp.int32))
    logits, caches = api.prefill(params, torch.as_tensor(toks))
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j), rtol=0, atol=TOL)
    assert len(caches) == cfg.n_layers
    U = cfg.unit_size
    for layer, cache in enumerate(caches):
        want = caches_j[f"b{layer % U}"]
        kind = "KVCache" if cfg.layer_kind(layer % U) == "attn" else "SSMCache"
        assert type(cache).__name__ == kind and len(cache) == len(want)
        for got, ref in zip(cache, want):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref[layer // U]), rtol=0,
                                       atol=TOL, err_msg=f"layer {layer}")
    total = S + steps
    caches_j = {pos: _pad_kv_j(c, total) if cfg_j.layer_kind(int(pos[1:])) == "attn" else c
                for pos, c in caches_j.items()}
    caches = [_pad_kv(c, total) if cfg.layer_kind(layer % U) == "attn" else c
              for layer, c in enumerate(caches)]
    step_j = jax.jit(api_j.decode_step)
    tok_j = jnp.argmax(logits_j, -1).astype(jnp.int32)
    tok = torch.argmax(logits, -1)
    for i in range(S, total):
        np.testing.assert_array_equal(tok.numpy(), np.asarray(tok_j))
        logits_j, caches_j = step_j(params_j, caches_j, tok_j, jnp.asarray(i, jnp.int32))
        logits, caches = api.decode_step(params, caches, tok, i)
        np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j), rtol=0, atol=TOL,
                                   err_msg=f"decode step at {i}")
        tok_j = jnp.argmax(logits_j, -1).astype(jnp.int32)
        tok = torch.argmax(logits, -1)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(tok_j))


@pytest.mark.parametrize("name", ["olmoe-1b-7b", "grok-1-314b"])
def test_moe_serving_path_matches(name):
    check_lm_path(name)


@pytest.mark.parametrize("name", ["olmoe-1b-7b", "grok-1-314b"])
def test_build_accepts_moe_models(name):
    cfg = configs.get_arch(name)
    api = models.build(cfg)
    assert cfg.layer_moe(0)
    # the training loss is ported (it raised until the training slice): a
    # finite loss with the MoE aux loss among its metrics
    small = cfg.reduced()
    params = models.build(small).init(torch.Generator().manual_seed(0), "cpu")
    toks = torch.zeros((1, 8), dtype=torch.int64)
    with torch.no_grad():
        loss, metrics = models.build(small).loss(params, toks, toks)
    assert bool(torch.isfinite(loss)) and set(metrics) == {"xent", "moe_aux"}
    assert callable(api.loss)


def _layer_drops(pkg_blocks, pkg_attn, pkg_moe, pkg_norm, cfg, layers, x, positions):
    """Run ``x`` through ``layers`` block by block in one package and count,
    at each MoE layer, the (token, choice) pairs its capacity dispatch
    drops: a list of (dropped, pairs) per layer."""
    out = []
    for p in layers:
        h = pkg_norm(x, p["ln1"], cfg.norm_eps)
        x1 = x + pkg_attn.attn_train(p["attn"], cfg, h, positions)[0]
        h2 = pkg_norm(x1, p["ln2"], cfg.norm_eps)
        kept, pairs = 0, 0
        for c0 in range(0, h2.shape[1], cfg.moe_chunk):
            disp = pkg_moe._route(p["moe"], cfg, h2[:, c0 : c0 + cfg.moe_chunk])[1]
            kept += int(np.asarray(disp).sum())
            pairs += h2.shape[0] * min(cfg.moe_chunk, h2.shape[1] - c0) * cfg.top_k
        out.append((pairs - kept, pairs))
        x = pkg_blocks.block_train(p, cfg, 0, x, positions)[0]
    return out


@pytest.fixture
def one_torch_thread():
    """torch on one CPU thread for a test that takes the same time alone
    either way, while other test files run beside it on the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_olmoe_drop_share_matches_the_reference(one_torch_thread):
    """olmoe-1b-7b at a middle width (d_model 512, 4 layers, all 64 experts
    top-8, capacity 1.25, chunks of 512) on one set of the reference's
    weights: the share of (token, choice) pairs each layer's capacity
    dispatch drops is the reference's, to 0.1% of the pairs (a near tie
    between a token's 8th and 9th gate may route one choice elsewhere)."""
    from repro.models import attention as jattention
    from repro.models import blocks as jblocks
    from repro.models import common as jcommon
    from repro_torch.models import attention, blocks, common

    mid = dict(n_layers=4, d_model=512, n_heads=4, n_kv=4, d_head=128, vocab=4096,
               moe_chunk=512, param_dtype=jnp.float32, compute_dtype=jnp.float32)
    cfg_j = dataclasses.replace(jconfigs.get_arch("olmoe-1b-7b"), **mid)
    cfg = dataclasses.replace(configs.get_arch("olmoe-1b-7b"),
                              **{**mid, "param_dtype": torch.float32,
                                 "compute_dtype": torch.float32})
    assert (cfg.n_experts, cfg.top_k, cfg.capacity_factor, cfg.d_ff) == (64, 8, 1.25, 1024)
    params_j, _ = jmodels.build(cfg_j).init(jax.random.key(0))
    params = lm_params_from_numpy(jax.tree.map(np.asarray, params_j), cfg, "cpu")
    B, S = 1, 1024
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (B, S))
    layers_j = [jax.tree.map(lambda a, i=i: a[i], params_j["unit"]["b0"])
                for i in range(cfg.n_layers)]
    x_j = params_j["tok_embed"][jnp.asarray(toks)]
    pos_j = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))
    with torch.no_grad():
        got = _layer_drops(blocks, attention, moe, common.rms_norm, cfg, params["layers"],
                           params["tok_embed"][torch.as_tensor(toks)],
                           torch.arange(S).expand(B, S))
    want = _layer_drops(jblocks, jattention, jmoe, jcommon.rms_norm, cfg_j, layers_j, x_j, pos_j)
    for layer, ((d, n), (d_j, n_j)) in enumerate(zip(got, want)):
        print(f"layer {layer}: port drops {d / n:.4%}, reference {d_j / n_j:.4%} of {n} pairs")
        assert n == n_j and abs(d - d_j) <= 1e-3 * n, (layer, d, d_j, n)
