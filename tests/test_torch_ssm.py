"""The port's Mamba-2 SSD block and the SSM and hybrid serving paths against
the reference, on ``reduced()`` configs in float32 with the reference's
weights carried across by ``convert``.

``_ssd_scan`` (the chunked scan over several chunks: its output and final
state), ``_causal_conv`` and ``ssd_decode`` (output and both caches) within
2e-5.  The whole path (mamba2-1.3b: SSD layers only; jamba-v0.1-52b: a unit
of 7 SSD and 1 attention layers, MoE on every second): prefill logits and
every layer's cache within 2e-5 with a prompt past ``attn_chunk``, then
three greedy decode steps from the prefill's caches (the SSD layers' state
and conv window, the attention layer's KV cache), logits within 2e-5 and
tokens equal (``test_torch_moe.check_lm_path``).
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import ssm as jssm  # noqa: E402
from repro_torch import configs, models  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from test_torch_moe import TOL, _cfgs, check_lm_path  # noqa: E402


def _ssd_params(cfg_j, key=3):
    """The reference's SSD weights, with a non-zero conv bias, in both
    packages."""
    p_j, _ = jssm.init_ssd(jax.random.key(key), cfg_j)
    p_j = dict(p_j, conv_b=0.1 * jax.random.normal(jax.random.key(key + 1),
                                                    p_j["conv_b"].shape))
    return p_j, {k: torch.as_tensor(np.array(v)) for k, v in p_j.items()}


def test_ssd_scan_matches():
    cfg_j, cfg = _cfgs("mamba2-1.3b")
    rng = np.random.default_rng(4)
    B, S, H, P, N = 2, 4 * cfg.ssd_chunk, 8, cfg.ssm_headdim, cfg.ssm_state
    xh = rng.normal(size=(B, S, H, P)).astype(np.float32)
    dt = rng.uniform(0.001, 0.1, size=(B, S, H)).astype(np.float32)
    A = -rng.uniform(1.0, 16.0, size=H).astype(np.float32)
    Bh = rng.normal(size=(B, S, H, N)).astype(np.float32)
    Ch = rng.normal(size=(B, S, H, N)).astype(np.float32)
    y_j, h_j = jax.jit(lambda *a: jssm._ssd_scan(cfg_j, *a))(xh, dt, A, Bh, Ch)
    y, h = ssm._ssd_scan(cfg, *(torch.as_tensor(a) for a in (xh, dt, A, Bh, Ch)))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), rtol=0, atol=TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_j), rtol=0, atol=TOL)


def test_causal_conv_and_ssd_decode_match():
    cfg_j, cfg = _cfgs("mamba2-1.3b")
    p_j, p = _ssd_params(cfg_j)
    rng = np.random.default_rng(6)
    d_inner, H, P, N, G = ssm._dims(cfg)
    xbc = rng.normal(size=(2, 37, d_inner + 2 * G * N)).astype(np.float32)
    np.testing.assert_allclose(ssm._causal_conv(p, cfg, torch.as_tensor(xbc)).numpy(),
                               np.asarray(jssm._causal_conv(p_j, cfg_j, jnp.asarray(xbc))),
                               rtol=0, atol=TOL)
    # a cache with a state and a conv window in it, then three steps
    cache_j = jssm.SSMCache(
        h=jnp.asarray(rng.normal(size=(2, H, N, P)).astype(np.float32)),
        conv=jnp.asarray(rng.normal(size=(2, cfg.ssm_conv - 1, xbc.shape[-1]))
                         .astype(np.float32)),
    )
    cache = ssm.SSMCache(*(torch.as_tensor(np.array(a)) for a in cache_j))
    step_j = jax.jit(lambda x, c: jssm.ssd_decode(p_j, cfg_j, x, c))
    for _ in range(3):
        x = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
        y_j, cache_j = step_j(jnp.asarray(x), cache_j)
        y, cache = ssm.ssd_decode(p, cfg, torch.as_tensor(x), cache)
        np.testing.assert_allclose(y.numpy(), np.asarray(y_j), rtol=0, atol=TOL)
        for got, want in zip(cache, cache_j):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


def test_ssd_train_matches():
    cfg_j, cfg = _cfgs("mamba2-1.3b")
    p_j, p = _ssd_params(cfg_j, key=8)
    x = np.random.default_rng(9).normal(size=(2, 3 * cfg.ssd_chunk, cfg.d_model))
    x = x.astype(np.float32)
    y_j, cache_j = jax.jit(lambda v: jssm.ssd_train(p_j, cfg_j, v))(jnp.asarray(x))
    y, cache = ssm.ssd_train(p, cfg, torch.as_tensor(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), rtol=0, atol=TOL)
    for got, want in zip(cache, cache_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


@pytest.mark.parametrize("name", ["mamba2-1.3b", "jamba-v0.1-52b"])
def test_ssm_serving_path_matches(name):
    check_lm_path(name)


@pytest.mark.parametrize("name", ["mamba2-1.3b", "jamba-v0.1-52b"])
def test_build_accepts_ssd_models(name):
    cfg = configs.get_arch(name)
    models.build(cfg)
    kinds = {cfg.layer_kind(pos) for pos in range(cfg.unit_size)}
    assert "ssd" in kinds
